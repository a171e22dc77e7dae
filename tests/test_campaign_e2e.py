"""End-to-end campaign engine test on CPU: solve_ensemble_batch through
the CLI main, on a tiny shipped wishart folder with exact ground truths —
covers record streaming, --trace residual curves, the .partial crash
snapshot, and per-instance resume (the machinery the deep-budget device runs
depend on)."""

import json
import os

import pytest

FOLDER = ("/root/reference/NPT/examples/wishart_small/"
          "wishart_planting_N_10_alpha_0.50")


@pytest.mark.skipif(not os.path.isdir(FOLDER),
                    reason="reference wishart_small not present")
def test_campaign_ensemble_trace_and_resume(tmp_path):
    from nmc_tpu.campaign import main

    out = str(tmp_path / "camp.jsonl")
    args = ["--folder", FOLDER, "--kind", "wishart",
            "--instances", "4", "--replicas", "8", "--beta-max", "8",
            "--chunk-rounds", "3", "--sweeps", "8000", "--arm", "pt",
            "--trace", "--out", out]
    main(args)

    recs = [json.loads(l) for l in open(out)]
    assert len(recs) == 4
    for r in recs:
        assert r["gs_raw"] is not None
        assert r["rounds_completed"] >= 1
        if r["hit"]:
            assert r["hit_seconds"] is not None
            assert abs(r["residual"]) <= max(1e-6 * abs(r["gs_raw"]), 1e-6)
    # N=10 alpha=0.50 is trivially easy — PT at 8 replicas must solve some
    assert sum(r["hit"] for r in recs) >= 2

    # trace rows streamed per chunk with strict-JSON residuals
    trace = [json.loads(l) for l in open(out + ".trace")]
    assert trace and all(len(t["residual_raw"]) == 4 for t in trace)
    assert trace[-1]["hits"] == sum(r["hit"] for r in recs)

    # the crash snapshot is superseded (removed) on clean completion
    assert not os.path.exists(out + ".partial")

    # resume: a second invocation skips everything already recorded
    main(args)
    recs2 = [json.loads(l) for l in open(out)]
    assert len(recs2) == 4


@pytest.mark.skipif(not os.path.isdir(FOLDER),
                    reason="reference wishart_small not present")
def test_campaign_hybrid_arm_cli(tmp_path):
    from nmc_tpu.campaign import main

    out = str(tmp_path / "hy.jsonl")
    main(["--folder", FOLDER, "--kind", "wishart",
          "--instances", "4", "--replicas", "8", "--beta-max", "8",
          "--chunk-rounds", "3", "--sweeps", "8000", "--arm", "hybrid",
          "--subreplicas", "2", "--nmc-cold", "3", "--out", out])
    recs = [json.loads(l) for l in open(out)]
    assert len(recs) == 4
    assert sum(r["hit"] for r in recs) >= 2
    assert recs[0]["meta"]["arm"] == "hybrid"


@pytest.mark.skipif(not os.path.isdir(FOLDER),
                    reason="reference wishart_small not present")
def test_campaign_spectral_arm_cli(tmp_path):
    from nmc_tpu.campaign import main

    out = str(tmp_path / "sp.jsonl")
    main(["--folder", FOLDER, "--kind", "wishart",
          "--instances", "4", "--arm", "spectral",
          "--spectral-polish", "8", "--out", out])
    recs = [json.loads(l) for l in open(out)]
    assert len(recs) == 4
    # N=10 alpha=0.50 integer-quantized: spectral must solve all of them
    assert sum(r["hit"] for r in recs) == 4
    for r in recs:
        assert r["meta"]["arm"] == "spectral"
        assert r["meta"]["sweeps"] == 0
        assert r["hit_seconds"] is not None and r["hit_seconds"] < 60


@pytest.mark.skipif(not os.path.isdir(FOLDER),
                    reason="reference wishart_small not present")
def test_campaign_init_spectral_seeding_cli(tmp_path):
    from nmc_tpu.campaign import main

    out = str(tmp_path / "sd.jsonl")
    main(["--folder", FOLDER, "--kind", "wishart",
          "--instances", "4", "--replicas", "8", "--beta-max", "8",
          "--chunk-rounds", "2", "--sweeps", "800",
          "--arm", "icm", "--subreplicas", "2",
          "--init", "spectral", "--init-chains", "2", "--out", out])
    recs = [json.loads(l) for l in open(out)]
    assert len(recs) == 4
    # seeds start IN the planted basin: hits land in the first chunk
    assert sum(r["hit"] for r in recs) == 4
    for r in recs:
        assert r["meta"]["init"] == "spectral"
        assert r["meta"]["init_chains"] == 2


CHIMERA128 = ("/root/reference/NMC/examples/Chimera_droplet_instances/"
              "chimera128_spinglass_power")


@pytest.mark.skipif(not os.path.isdir(CHIMERA128),
                    reason="reference chimera128 not present")
def test_campaign_init_file_seeding_and_only_cli(tmp_path):
    """--init file seeds the coldest chains from per-instance state
    files (the beam-seeded-MCMC portfolio stage); seeding with the
    SHIPPED ground states must hit in the first chunk. --only restricts
    the batch to the named instances."""
    import numpy as np

    from nmc_tpu.campaign import main
    from nmc_tpu.io.loaders import read_otn2d_groundstates

    truths = read_otn2d_groundstates(
        os.path.join(CHIMERA128, "groundstates_otn2d.txt"))
    sdir = tmp_path / "states"
    sdir.mkdir()
    for nm in ("002.txt", "004.txt"):
        np.savetxt(str(sdir / nm), truths[nm][1].astype(np.int8), fmt="%d")

    out = str(tmp_path / "fs.jsonl")
    main(["--folder", CHIMERA128, "--kind", "chimera",
          "--instances", "5", "--only", "002.txt,004.txt",
          "--replicas", "8", "--beta-max", "30",
          "--chunk-rounds", "1", "--sweeps", "96",
          "--arm", "icm", "--subreplicas", "2",
          "--init", "file", "--init-states", str(sdir),
          "--init-chains", "2", "--out", out])
    recs = [json.loads(l) for l in open(out)]
    assert sorted(r["name"] for r in recs) == ["002.txt", "004.txt"]
    for r in recs:
        assert r["hit"] and r["meta"]["init"] == "file"
        assert r["rounds_completed"] == 1


@pytest.mark.skipif(not os.path.isdir(FOLDER),
                    reason="reference wishart_small not present")
def test_campaign_save_best_states_checkpoint(tmp_path):
    """--save-best-states checkpoints each instance's best full-space
    +-1 state per improving chunk, in the exact format --init file
    re-seeds from — so a killed deep run keeps its Monte Carlo progress
    and near-converged misses feed the strip refiner."""
    import numpy as np

    from nmc_tpu.campaign import main
    from nmc_tpu.evaluation import wishart_folder_instances

    out = str(tmp_path / "bs.jsonl")
    sdir = tmp_path / "best"
    main(["--folder", FOLDER, "--kind", "wishart",
          "--instances", "2", "--replicas", "8", "--beta-max", "8",
          "--chunk-rounds", "3", "--sweeps", "8000", "--arm", "pt",
          "--save-best-states", str(sdir), "--out", out])
    recs = {json.loads(l)["name"]: json.loads(l) for l in open(out)}
    probs = {nm: p for nm, p, _ in
             wishart_folder_instances(FOLDER, limit=2)}
    assert len(recs) == 2
    for nm, r in recs.items():
        st = np.loadtxt(str(sdir / nm))
        assert st.shape == (probs[nm].n,) and set(np.unique(st)) <= {-1, 1}
        # the checkpointed state's raw energy matches the recorded best
        # (normalized problem energy * norm factor == found_raw)
        pn, factor = probs[nm].normalized()
        e_raw = float(pn.energy(st)) * factor
        assert abs(e_raw - r["found_raw"]) <= 1e-6 * max(1, abs(e_raw))

    # the checkpoints round-trip through --init file seeding
    out2 = str(tmp_path / "bs2.jsonl")
    main(["--folder", FOLDER, "--kind", "wishart",
          "--instances", "2", "--replicas", "8", "--beta-max", "8",
          "--chunk-rounds", "1", "--sweeps", "200", "--arm", "pt",
          "--init", "file", "--init-states", str(sdir),
          "--init-chains", "2", "--out", out2])
    assert len([l for l in open(out2)]) == 2


@pytest.mark.skipif(not os.path.isdir(FOLDER),
                    reason="reference wishart_small not present")
def test_campaign_presolve_noop_on_coreful_family(tmp_path):
    """--presolve on a pure-core family (no trees) is an exact no-op:
    same hits, records in original raw units."""
    from nmc_tpu.campaign import main

    out = str(tmp_path / "ps.jsonl")
    main(["--folder", FOLDER, "--kind", "wishart",
          "--instances", "4", "--replicas", "8", "--beta-max", "8",
          "--chunk-rounds", "3", "--sweeps", "8000", "--arm", "pt",
          "--presolve", "--out", out])
    recs = [json.loads(l) for l in open(out)]
    assert len(recs) == 4
    assert sum(r["hit"] for r in recs) >= 2
    assert recs[0]["meta"]["presolve"] == "peel"
    for r in recs:
        assert r["n"] == 10                     # original size reported
        assert r["gs_raw"] is not None


TREES20 = ("/root/reference/NMC/examples/contrived_wishart_backbone/"
           "wishart_contrived_trees/"
           "wishart_planting_N_20_alpha_0.20_contrived_tree")


@pytest.mark.skipif(not os.path.isdir(TREES20),
                    reason="reference contrived trees not present")
def test_campaign_presolve_spectral_arm_contrived(tmp_path):
    """Spectral arm + presolve on the tree-decorated family: energies come
    back in original raw units (core search + folded constant) and match
    an independent f64 evaluation of the expanded state's energy scale."""
    from nmc_tpu.campaign import main

    out = str(tmp_path / "sp.jsonl")
    main(["--folder", TREES20, "--kind", "contrived",
          "--instances", "3", "--arm", "spectral", "--presolve",
          "--spectral-dm", "128", "--spectral-polish", "4",
          "--out", out])
    recs = [json.loads(l) for l in open(out)]
    assert len(recs) == 3
    for r in recs:
        # raw units: the family's tree energies are O(-200) per instance
        assert r["found_raw"] is not None and r["found_raw"] < -100

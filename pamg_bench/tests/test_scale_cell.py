"""The scaling-row cell (``scale589824_ns7.v8_pcg``) in the tiny copy of
the benchmark on the CPU: its configuration at its own split (the mix's 8
levels need n_split 7) on the smallest generated mesh, 2 macros (98,304
DOF) in place of its 36, end to end and correct, with its per-layer
readers on a program that has no card.

    python -m pytest -q pamg_bench/tests

This module gives the tiny copy (``conftest.make_tiny``) the cut of the
new configuration when pytest collects it, before any test builds the
copy.
"""

from pamg_bench import run, spec

from .conftest import ROOT, TINY

CELL = "scale589824_ns7.v8_pcg"
SEED = 2 ** 31 + 977
TINY.setdefault("scale589824_ns7", ([1, 1, 1.0, 0.5], 7, {}))


def test_scale_cell_found_by_name():
    """The cell's files by name: the configuration's 36 macros at n_split
    7 in float32, cut by nothing; the mix's 8-level V-cycle PCG on the
    block stencil up to 4**7 children a macro; the three per-layer metrics
    that list it, after the end-to-end ones."""
    cell = spec.load_cell(ROOT, CELL, trace=True)
    assert cell.config["reduced"] == [] and cell.chips == 1
    assert cell.config["sizes"]["dof"] == 3 * 36 * 4 ** 7
    fields = cell.semi_fields()
    assert (fields["n_split"], fields["multi_levels"], fields["cycle_type"],
            fields["stencil_max_children"]) == (7, 8, "v", 4 ** 7)
    assert [m for m, _, _ in cell.metrics] == [
        "k1_stream_hbm_roofline_share", "k1_stream_launches_per_step",
        "setup_stencils_s"]
    assert set(cell.limits) == {"rel_residual"}


def test_tiny_scale_cell_runs_and_is_correct(tiny):
    """The tiny cell end to end, correct; on the CPU no K1 launch runs,
    so the streaming launches read 0 a step and the roofline nothing,
    while the stencils' stage reads its seconds."""
    from p_a_multigrids_tpu_torch.utils import tracing
    out = run.run_cell(CELL, SEED, 0.5, False, device="cpu", root=tiny,
                       pkg=tiny / "pkg")
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) >= {"step_ms", "setup_s"}
    assert tracing.snapshot()["counters"]["steps"] >= out["attempted"]
    read = {name: spec.load_metric(name).read({"kernels": []}) for name in (
        "k1_stream_launches_per_step", "setup_stencils_s",
        "k1_stream_hbm_roofline_share")}
    assert read["k1_stream_launches_per_step"] == 0.0
    assert read["setup_stencils_s"] > 0
    assert read["k1_stream_hbm_roofline_share"] is None

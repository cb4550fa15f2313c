"""The roofline counts at the cells' shapes, and no larger than the counts
the port's smoke script printed for the same shapes."""

import numpy as np
import pytest
import torch

from portbench.counts import linear, trees
from portbench.counts.peaks import rates
from portbench.counts.roofline import empty, least_seconds

R = rates()


def test_rates_follow_the_published_peaks():
    assert R["fp32"] == 67e12 and R["hbm"] == 3.35e12
    assert R["tc"] == pytest.approx(165e12)
    assert R["sfu"] == pytest.approx(132 * 16 * 1.98e9)
    assert R["int"] == pytest.approx(132 * 64 * 1.98e9)


@pytest.mark.parametrize("kind, alone", [
    ("contraction_flop", lambda w: w / (R["tc"] + R["fp32"])),
    ("fp32_flop", lambda w: w / R["fp32"]),
    ("special", lambda w: 2 * w / (2 * R["sfu"] + R["fp32"])),
    ("int_ops", lambda w: w / R["int"]),
    ("bytes", lambda w: w / R["hbm"]),
])
def test_one_kind_of_work_alone_uses_every_unit_that_can_do_it(kind, alone):
    work = empty()
    work[kind] = 1e12
    seconds, by = least_seconds(work)
    assert seconds == pytest.approx(alone(1e12))
    assert by == ("bytes" if kind == "bytes" else "operations")


@pytest.mark.parametrize("contraction, fp32", [(1e13, 1e12), (1e12, 1e12)])
def test_shared_fp32_lanes_are_not_counted_twice(contraction, fp32):
    # FP32-only work needs the lanes alone; both kinds share them with
    # the tensor cores taking only the contractions
    work = empty()
    work["contraction_flop"], work["fp32_flop"] = contraction, fp32
    seconds, _ = least_seconds(work)
    assert seconds == pytest.approx(max(fp32 / R["fp32"],
                                        (contraction + fp32) / (R["tc"] + R["fp32"])))


def test_covertype_chunk_count_is_pinned_and_below_the_smoke_scripts():
    # one 65,536-row chunk of the Covertype explain (S = 2072, N = 100,
    # M = 12, K = 7, D = 54); chip_smoke.py's factored count was 6.0241 ms
    # (PERF.md's kernel table), with both contractions on the FP32 lanes
    seconds, by = least_seconds(linear.masked_eval(65536, 2072, 100, 12, 7, 54))
    assert by == "operations"
    assert seconds * 1e3 == pytest.approx(1.7978, abs=1e-4)
    assert seconds * 1e3 <= 6.0241


def test_the_count_is_for_the_general_softmax_only():
    with pytest.raises(ValueError):
        linear.masked_eval(2560, 2072, 100, 12, 2, 49)


def test_smoke_script_counts_agree_with_the_constants():
    chip_smoke = pytest.importorskip("chip_smoke")
    ms, _ = chip_smoke.ey_bound_ms(65536, 2072, 100, 12, 7, "softmax", 132, 1.98e9,
                                   design="factored")
    ours, _ = least_seconds(linear.masked_eval(65536, 2072, 100, 12, 7, 54))
    assert ms == pytest.approx(6.0241, abs=1e-4) and ours * 1e3 <= ms


@pytest.mark.parametrize("call, pinned_ms", [("explain", 16.8528), ("rank_features", 16.8528)])
def test_covertype_call_count_is_pinned(call, pinned_ms):
    # the whole call over 581,012 rows (the operations bound it, so
    # rank_features, which writes only the importance, counts the same)
    work = linear.explain(581012, 2072, 100, 12, 7, 54, phi_bytes=2.0,
                          return_phi=call == "explain")
    seconds, by = least_seconds(work)
    assert by == "operations"
    assert seconds * 1e3 == pytest.approx(pinned_ms, abs=1e-3)


def _adult_gbt(rows):
    from portbench import harness

    spec = harness.load_spec()
    _, config, traffic = harness.find_cell(spec, "adult_gbt.inter_2560")
    config["rows"] = rows
    traffic["rows"] = rows
    system = harness.kind_module(config).build(config, 20260101, "cpu")
    return system, traffic


def test_interaction_count_is_no_larger_than_the_smoke_scripts():
    # chip_smoke.inter_bound_ms counted 6 integer operations per triple on
    # a path and its kernel design's multiplies and adds (0.0142 ms at
    # B = 256 on its seed's ensemble, PERF.md's kernel table); on the same inputs
    # this count must not exceed it
    chip_smoke = pytest.importorskip("chip_smoke")
    system, traffic = _adult_gbt(256)
    work = system.work(traffic, "cpu")
    ours, _ = least_seconds(work["exact_tree_inter"])
    args, _ = chip_smoke.dense_inputs(system.explainer, system.rows(traffic),
                                      torch.device("cpu"))
    theirs_ms, _, _ = chip_smoke.inter_bound_ms(args, 132, 1.98e9)
    assert 0 < ours * 1e3 <= theirs_ms


def test_triple_stats_count_live_triples_by_hand():
    # one path over groups {0, 1}; x fails group 1, z_0 fails group 0 (so
    # U = {0}, V = {1}: u = v = 1), z_1 fails both (dead)
    on_path = torch.tensor([[True, True, False]])
    x_fail = torch.tensor([[[False, True, False]]])
    z_fail = torch.tensor([[[True, False, False]], [[True, True, False]]])
    stats = trees.triple_stats(x_fail, z_fail, on_path)
    assert stats == {"on": 2.0, "phi_fp": 3.0, "inter_fp": 3.0}
    w = trees.interactions(stats, B=1, N=2, D=3, M=3, tables_b=0.0)
    assert w["int_ops"] == 4.0 and w["fp32_flop"] == 3.0
    assert w["bytes"] == 4.0 * (3 + 6) + 4.0 * 9


def test_counts_grow_with_the_work():
    small = least_seconds(linear.masked_eval(1000, 2072, 100, 12, 7, 54))[0]
    big = least_seconds(linear.masked_eval(2000, 2072, 100, 12, 7, 54))[0]
    assert np.isclose(big / small, 2.0, rtol=0.05)

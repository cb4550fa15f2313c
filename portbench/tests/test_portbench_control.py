"""What decides ``correct`` has to fail what it should.

On the card, at each cell's own size: the control (the reference computed
with TF32 products, the next precision below the configuration's float32,
rounded as the port's result is) stands in the port's place and must fail
one of the cell's numbers while the port passes every one.  On the CPU, at a
tiny size: a run whose timed path is broken underneath, by leaving half of
the background out (the mean taken over the rest) or by altering an answer
where it is produced, must come out not correct.
"""

import pytest

from portbench.tests.test_portbench_harness import CELLS, TINY

SEEDS = (1000003, 2000003, 3000017)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_port_passes_at_the_cells_size(cell, seed, cuda_card):
    from portbench import calibrate, harness

    rec = calibrate.readings(cell, seed, 1, cuda_card)
    _, config, _ = harness.find_cell(harness.load_spec(), cell)
    limits = config["limits"]
    assert all(v <= limits[n] for n, v in rec["program"].items()), rec
    assert any(v > limits[n] for n, v in rec["control"].items()), rec


def _half_background(bgw):
    kept = bgw.clone()
    kept[1::2] = 0.0
    return kept / kept.sum()


def _break(monkeypatch, cell, fault):
    """Patch the port's timed path underneath the harness."""

    from distributedkernelshap_tpu_torch.kernel_shap import KernelExplainerEngine
    from distributedkernelshap_tpu_torch.ops import explain, treeshap

    if cell.startswith("covertype_lr"):
        ey = explain.fused_linear_ey
        if fault == "half_batch":
            def broken(XWg, bgWg, bgW, bgw, mask, activation):
                return ey(XWg, bgWg, bgW, _half_background(bgw), mask, activation)
            monkeypatch.setattr(explain, "fused_linear_ey", broken)
        elif cell.endswith("rank_all"):
            importance = KernelExplainerEngine.get_importance

            def altered(self, X, nsamples=None):
                out = importance(self, X, nsamples=nsamples)
                out[0, 0] *= 1.01
                return out
            monkeypatch.setattr(KernelExplainerEngine, "get_importance", altered)
        else:
            def altered(*args):
                out = ey(*args)
                out[out.shape[0] // 2] *= 1.01
                return out
            monkeypatch.setattr(explain, "fused_linear_ey", altered)
        return
    for name in ("exact_tree_phi", "exact_tree_inter"):
        fn = getattr(treeshap, name)

        def broken(xo, xn, zo, zd, lv, bgw, dmax, fn=fn):
            if fault == "half_batch":
                return fn(xo, xn, zo, zd, lv, _half_background(bgw), dmax=dmax)
            out = fn(xo, xn, zo, zd, lv, bgw, dmax=dmax)
            out[out.shape[0] // 2] += 1e-3
            return out
        monkeypatch.setattr(treeshap, name, broken)


@pytest.mark.parametrize("fault", [None, "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_comes_out_not_correct(cell, fault, monkeypatch):
    from portbench import harness

    if fault:
        _break(monkeypatch, cell, fault)
    line, checks = harness.run(cell, 77777777777, 0.5, False, device="cpu",
                               overrides=TINY[cell.split(".")[0]])
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["correct"] is (fault is None), checks

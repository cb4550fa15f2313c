"""The exact kernels' walks by path slot, on the CPU.

``exact_tree_inter`` runs by path slot from ``INTER_SLOT_M`` groups and
``exact_tree_phi`` from ``MAX_TREE_M``: each path's groups are gathered into
slots (``path_slots``), the lanes of a warp own slot pairs of the walked
path, and sums go back to their groups at a flush.  The CUDA kernels run
only on the card, so here:

* ``exact_tree_inter_slots_plain`` (the slot layout in plain PyTorch) is
  held against ``exact_tree_inter_plain`` and the JAX ``exact_tree_inter``
  (the Pallas kernel in interpret mode) at M = 24 and 32;
* a float32 numpy emulation of the inter kernel's walk (slot pairs of the
  walked path in bands of 256, the VV sum and the leaf value at the flush,
  a triangle of group pairs per warp, the tile sum) against the plain
  version, the all-on-path case taking three bands;
* a float32 numpy emulation of the phi kernel's by-slot epilogue (slot by
  slot, each group's lanes summed in lane order) against
  ``exact_tree_phi_slots_plain`` at M = 100;
* ``path_slots`` reads nothing back from the device up to 64 groups, and
  the wrappers take the slot table (the slot-table kernels', whose plain
  version ``slot_table`` gives on the CPU) from their kernel's slot width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from distributedkernelshap_tpu.ops.pallas_kernels import exact_tree_inter as pallas_inter
from distributedkernelshap_tpu_torch.ops import cuda_kernels as tck

RAW_TOL = 3e-5          # atol and rtol on the raw pairwise sum
PHI_REL = 2e-5          # x max(1, max|phi|)
LANES = 32              # paths a warp walks: one per lane
PAIRS_PER_BAND = 32 * 8  # kSlotPPL = 8 slot pairs a lane


def _inputs(M, depth, kind, B=3, P=24, N=20, K=2, seed=0):
    """Tree-path-shaped inputs: each path holds at most ``depth`` groups
    (``None``: each group lies on a path at a rate of 0.4)."""

    rng = np.random.default_rng([seed, M, depth or 0])
    return cs.phi_edge_inputs(rng, B, P, N, M, K, "cpu", kind, path_groups=depth)


def _tri(j):
    return j * (j + 1) // 2


def _slot_pair(s):
    j = 0
    while _tri(j + 1) <= s:
        j += 1
    return s - _tri(j), j


def _masks(x, slots):
    """Per (row, path) the slot bits of the 0/1 ``x (R, P, M)``, as ints."""

    R, P, _ = x.shape
    out = np.zeros((R, P), dtype=object)
    for p in range(P):
        for j, g in enumerate(slots[p]):
            if g < 0:
                break
            out[:, p] += (x[:, p, g] > 0.5).astype(np.int64).astype(object) << j
    return out


def emulate_inter_slot_walk(args, dmax):
    """``exact_tree_inter``'s slot walk in float32 numpy: per instance and
    32-path tile, background chunks of 64 rows, the warp's paths in order;
    for path q the slot pairs (i <= j) below its highest slot, in bands of
    256, summed over q's live rows with the tabled weights, then (the VV sum
    added on pairs of two x-not slots) times leaf_val[q] into a triangle of
    group pairs; the tiles summed in order."""

    xo_t, xn_t, zo_t, zd_t, lv_t, bgw_t = args
    B, P, M = xo_t.shape
    N, K = zo_t.shape[0], lv_t.shape[1]
    slots = tck.path_slots(xo_t, xn_t).numpy()
    xo, xn = _masks(xo_t.numpy(), slots), _masks(xn_t.numpy(), slots)
    zb = _masks(zo_t.numpy(), slots)
    dead = zd_t.numpy() > 0.5
    lv, bgw = lv_t.numpy(), bgw_t.numpy()
    tabs = tck.build_weight_tables("inter", dmax, M).numpy()
    T = _tri(M)
    tiles = -(-P // LANES)
    out = np.zeros((B, M, M, K), np.float32)
    for b in range(B):
        total = np.zeros((M, M, K), np.float32)
        for t in range(tiles):
            tri = np.zeros((K, T), np.float32)
            for n0 in range(0, N, tck.EXACT_CHUNK_ROWS):
                rows = range(n0, min(N, n0 + tck.EXACT_CHUNK_ROWS))
                for p in range(t * LANES, min(P, (t + 1) * LANES)):
                    o, x_n = int(xo[b, p]), int(xn[b, p])
                    v = bin(x_n).count("1")
                    live = []
                    for n in rows:
                        z = int(zb[n, p])
                        u = bin(o & ~z).count("1")
                        if not dead[n, p] and not (x_n & ~z) and (v >= 2 or u >= (1 if v else 2)):
                            live.append(n)
                    if not live:
                        continue
                    npairs = _tri((o | x_n).bit_length())
                    for s0 in range(0, npairs, PAIRS_PER_BAND):
                        pairs = [_slot_pair(s) for s in range(s0, min(npairs, s0 + PAIRS_PER_BAND))]
                        pm = [(1 << i) | (1 << j) for i, j in pairs]
                        mixed = [bool(x_n & m) and (x_n & m) != m for m in pm]
                        need = [m & ~x_n if mx else m for m, mx in zip(pm, mixed)]
                        acc = np.zeros(len(pm), np.float32)
                        vvs = np.float32(0.0)
                        for n in live:
                            su = o & ~int(zb[n, p])
                            u = bin(su).count("1")
                            w = np.float32(bgw[n])
                            vvs = np.float32(vvs + w * tabs[2, u, v])
                            if u == 0:
                                continue
                            wuu, wuv = np.float32(w * tabs[0, u, v]), np.float32(w * tabs[1, u, v])
                            add = np.array([(wuv if mx else wuu) if (su & nd) == nd else 0.0
                                            for nd, mx in zip(need, mixed)], np.float32)
                            acc = (acc + add).astype(np.float32)
                        for e, (i, j) in enumerate(pairs):
                            val = np.float32(acc[e] + (vvs if (x_n & pm[e]) == pm[e] else 0.0))
                            if val != 0.0:
                                at = _tri(slots[p, j]) + slots[p, i]
                                tri[:, at] = (tri[:, at] + val * lv[p]).astype(np.float32)
            for i in range(M):
                for j in range(M):
                    total[i, j] = (total[i, j] + tri[:, _tri(max(i, j)) + min(i, j)]).astype(
                        np.float32)
        out[b] = total
    return out


def emulate_phi_slot_epilogue(args, dmax):
    """``exact_tree_phi``'s by-slot epilogue in float32 numpy, on the per-path
    terms of the slot layout: per instance and 32-path tile, for each slot j
    below the tile's deepest slot, the paths whose slot j holds the same
    group summed in lane order, that sum added at the group; the tiles
    summed in order."""

    xo_t, xn_t, zo_t, zd_t, lv_t, bgw_t = args
    B, P, M = xo_t.shape
    K = lv_t.shape[1]
    slots_t = tck.path_slots(xo_t, xn_t)
    slots = slots_t.numpy()
    g = slots_t.long().clamp(min=0)
    valid = (slots_t >= 0).to(torch.float32)

    def gather(t):
        return torch.gather(t, 2, g[None].expand(t.shape[0], -1, -1)) * valid[None]

    xo_s, xn_s = gather(xo_t), gather(xn_t)
    d = tck._phi_path_terms(xo_s, xn_s, gather(zo_t), zd_t, bgw_t, min(dmax, M), None).numpy()
    on = ((xo_s + xn_s) > 0.5).numpy()                            # (B, P, S)
    lv = lv_t.numpy()
    phi = np.zeros((B, M, K), np.float32)
    for b in range(B):
        for t in range(-(-P // LANES)):
            lanes = range(t * LANES, min(P, (t + 1) * LANES))
            depth = max((int(np.flatnonzero(on[b, p]).max()) + 1 if on[b, p].any() else 0)
                        for p in lanes)
            row = np.zeros((M, K), np.float32)
            for j in range(depth):
                holders = {}
                for p in lanes:
                    if on[b, p, j]:
                        holders.setdefault(int(slots[p, j]), []).append(p)
                for grp, ps in holders.items():
                    s = np.zeros(K, np.float32)
                    for p in ps:
                        s = (s + np.float32(d[b, p, j]) * lv[p]).astype(np.float32)
                    row[grp] = (row[grp] + s).astype(np.float32)
            phi[b] = (phi[b] + row).astype(np.float32)
    return phi


# ---------------------------------------------------------------------------
# the slot layout of exact_tree_inter


@pytest.mark.parametrize("M,dmax", [(24, "1"), (24, "depth"), (32, "depth"), (32, "M")])
def test_inter_slot_layout_matches_plain_and_pallas(M, dmax):
    """``exact_tree_inter_slots_plain`` against the dense plain version and
    the Pallas kernel in interpret mode, at dmax 1 or 6 on paths of at most
    6 groups (a tree path's depth; dmax 1 counts past dmax), and at dmax = M
    with each group on a path at a rate of 0.4."""

    d = {"1": 1, "depth": 6, "M": M}[dmax]
    args = _inputs(M, None if dmax == "M" else 6, "random", seed=21)
    ref = np.asarray(pallas_inter(*(jnp.asarray(a.numpy()) for a in args), dmax=d,
                                  interpret=True))
    plain = tck.exact_tree_inter_plain(*args, dmax=d).numpy()
    slots = tck.exact_tree_inter_slots_plain(*args, dmax=d, chunk=7).numpy()
    assert slots.shape == (3, M, M, 2) and np.abs(ref).max() > 0
    np.testing.assert_allclose(slots, plain, atol=RAW_TOL, rtol=RAW_TOL)
    np.testing.assert_allclose(slots, ref, atol=RAW_TOL, rtol=RAW_TOL)
    # the wrapper takes the dense plain version for CPU tensors at any M
    assert torch.equal(tck.exact_tree_inter(*args, dmax=d), torch.as_tensor(plain))


@pytest.mark.parametrize("M,dmax,kind,shape", [
    (24, 6, "random", (3, 40, 70, 2)),
    (32, 32, "all live", (2, 33, 20, 3)),
    (32, 32, "all on path", (2, 8, 12, 1)),       # 528 slot pairs: three bands
    (64, 64, "none live", (2, 8, 12, 1)),
    (64, 8, "random", (2, 33, 70, 2)),
])
def test_inter_slot_walk_emulation_matches_plain(M, dmax, kind, shape):
    """The float32 emulation of the slot walk against the dense plain
    version and the slot layout (atol = rtol = 3e-5)."""

    B, P, N, K = shape
    args = _inputs(M, dmax, kind, B=B, P=P, N=N, K=K, seed=22)
    got = emulate_inter_slot_walk(args, dmax)
    plain = tck.exact_tree_inter_plain(*args, dmax=dmax).numpy()
    np.testing.assert_allclose(got, plain, atol=RAW_TOL, rtol=RAW_TOL)
    np.testing.assert_allclose(got, tck.exact_tree_inter_slots_plain(*args, dmax=dmax).numpy(),
                               atol=RAW_TOL, rtol=RAW_TOL)
    if kind == "none live":
        assert not got.any()
    else:
        assert np.abs(got).max() > 0 and np.allclose(got, np.swapaxes(got, 1, 2), atol=1e-6)


# ---------------------------------------------------------------------------
# the by-slot epilogue of exact_tree_phi


@pytest.mark.parametrize("kind,dmax", [("random", 8), ("all live", 30), ("random", 64)])
def test_phi_slot_epilogue_emulation_matches_plain_at_100_groups(kind, dmax):
    """The float32 emulation of the epilogue's order against
    ``exact_tree_phi_slots_plain`` and the dense plain version at M = 100
    (2e-5 · max(1, max|phi|)), over two path tiles."""

    args = _inputs(100, dmax, kind, B=4, P=45, N=30, K=2, seed=23)
    got = emulate_phi_slot_epilogue(args, dmax)
    for ref in (tck.exact_tree_phi_slots_plain(*args, dmax=dmax),
                tck.exact_tree_phi_plain(*args, dmax=dmax)):
        ref = ref.numpy()
        assert np.abs(got - ref).max() <= PHI_REL * max(1.0, float(np.abs(ref).max()))
    assert np.abs(got).max() > 0


# ---------------------------------------------------------------------------
# path_slots reads nothing back up to 64 groups


@pytest.mark.parametrize("M", [24, 64, 100])
def test_path_slots_syncs_only_past_64_groups(M, monkeypatch):
    """Up to 64 groups no path can hold more than the word's 64 slots, so
    ``path_slots`` reads no count back from the device (no ``.item()``,
    ``int()``, ``bool()`` or ``.tolist()`` of a tensor); past 64 it reads
    one to check that limit."""

    calls = []
    for name in ("item", "tolist", "__int__", "__bool__", "__float__", "__index__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    args = _inputs(M, 8, "random", B=2, P=10, N=4, K=1, seed=24)
    slots = tck.path_slots(args[0], args[1])
    monkeypatch.undo()
    assert slots.shape == (10, tck.MAX_TREE_M) and slots.dtype == torch.int32
    assert (calls == []) == (M <= tck.MAX_TREE_M), calls
    # the table is the same either way: each path's groups, ascending, then -1
    on = ((args[0] + args[1]) > 0.5).any(0)
    for p in range(10):
        groups = torch.nonzero(on[p]).flatten().tolist()
        assert slots[p].tolist() == groups + [-1] * (tck.MAX_TREE_M - len(groups))


@pytest.mark.parametrize("depth", [1, 8, None])
def test_slot_table_plain_is_path_slots_with_counts(depth):
    """``slot_table`` on CPU tensors (the plain version of the slot-table
    kernel) gives ``path_slots``' table and each path's group count, and
    raises nowhere: a path past 64 groups keeps its first 64."""

    args = _inputs(100, depth, "random", B=3, P=20, N=2, K=1, seed=25)
    table, counts = tck.slot_table(args[0], args[1])
    assert torch.equal(table, tck.path_slots(args[0], args[1]))
    on = ((args[0] + args[1]) > 0.5).any(0)
    assert counts.dtype == torch.int32 and counts.tolist() == on.sum(1).tolist()
    xo = torch.zeros(1, 2, 90)
    xo[0, 1, :70] = 1.0
    table, counts = tck.slot_table(xo, torch.zeros_like(xo))
    assert counts.tolist() == [0, 70] and table[1].tolist() == list(range(64))
    with pytest.raises(ValueError, match="70 groups"):
        tck.path_slots(xo, torch.zeros_like(xo))


class _SlotLibrary:
    """Stands in for a built exact-kernel library: records the slot-table
    and launch calls."""

    def __init__(self, name):
        self.slot_calls, self.slots_arg = [], []
        setattr(self, f"{name}_partial_tiles", lambda P: (P + 31) // 32)
        setattr(self, f"{name}_slot_table", self._slot_table)
        setattr(self, f"{name}_slot_table_ints", lambda P, M: P * 65 + (P * M + 3) // 4)
        setattr(self, f"{name}_launch", self._launch)

    def _slot_table(self, x_only, x_not, slots, B, P, M, stream):
        self.slot_calls.append((B, P, M))
        return 0

    def _launch(self, *cargs):
        self.slots_arg.append(cargs[7])
        return 0


@pytest.mark.parametrize("wrapper,M,by_slot", [
    ("exact_tree_inter", tck.INTER_SLOT_M - 1, False), ("exact_tree_inter", tck.INTER_SLOT_M, True),
    ("exact_tree_inter", 64, True), ("exact_tree_phi", 63, False), ("exact_tree_phi", 64, True)])
def test_wrappers_take_the_slot_table_from_their_width(wrapper, M, by_slot):
    """From its kernel's slot width the wrapper builds the slot table with
    the library's slot-table kernel and passes it to the launch, with no
    read back up to 64 groups; below it passes none.  Meta tensors stand in
    for the card."""

    fn = getattr(tck, wrapper)
    lib = _SlotLibrary(wrapper)
    args = [a.to("meta") for a in _inputs(M, 4, "random", B=3, P=40, N=5, K=1, seed=26)]
    shape = (3, M, 1) if wrapper == "exact_tree_phi" else (3, M, M, 1)
    assert tck._exact_run(fn, lib, 0, shape, args, dmax=4).shape == shape
    assert lib.slot_calls == ([(3, 40, M)] if by_slot else [])
    assert (lib.slots_arg[0] is not None) == by_slot


def test_inter_slot_route_width_and_interface():
    """The wrapper's slot threshold matches the source's, and the C
    occupancy queries take the classes (the by-slot triangles and rows
    depend on K)."""

    text = (tck.CSRC_DIR / "exact_tree_inter.cu").read_text()
    assert f"kSlotM = {tck.INTER_SLOT_M};" in text
    assert tck._SLOT_M == {"exact_tree_phi": ("exact_tree_phi_max_m", tck.MAX_TREE_M),
                           "exact_tree_inter": ("exact_tree_inter_slot_m", tck.INTER_SLOT_M)}
    for name in ("exact_tree_phi", "exact_tree_inter"):
        assert tck._SYMBOLS[name][f"{name}_smem_bytes"][0] == [tck._INT, tck._INT]
        assert tck._SYMBOLS[name][f"{name}_blocks_per_sm"][0] == [tck._INT, tck._INT]
    assert "exact_tree_inter_slot_m" in tck._SYMBOLS["exact_tree_inter"]
    for name in ("exact_tree_phi", "exact_tree_inter"):
        assert tck._SYMBOLS[name][f"{name}_slot_table"][0] == [tck._VOID] * 3 + [tck._INT] * 3 \
            + [tck._VOID]
    common = (tck.CSRC_DIR / "exact_tree_common.cuh").read_text()
    assert "slot_hits_kernel" in common and "slot_rank_kernel" in common
    # the slot table is a full 64 wide below 64 groups too
    xo = torch.zeros(1, 2, tck.INTER_SLOT_M)
    xo[0, 1, [3, 9]] = 1.0
    assert tck.path_slots(xo, torch.zeros_like(xo))[1, :3].tolist() == [3, 9, -1]


def test_kernel_ab_walls_use_each_checkouts_own_chip_smoke():
    """``scripts/torch_kernel_ab.py --walls`` runs one piece of code in each
    checkout's directory; it compiles and reads only names that
    ``chip_smoke.py`` has had since the wide phases were added."""

    from scripts import torch_kernel_ab as ab

    compile(ab.WALLS_CODE, "walls", "exec")
    for name in ("M_WIDE", "M_WIDEST", "M_INTER_WIDE", "B_EXACT", "B_WIDEST",
                 "B_INTER_WIDE", "wide_gbt", "explain_exact", "median_wall_ms"):
        assert f"cs.{name}" in ab.WALLS_CODE and hasattr(cs, name)


def test_exact_split_variants_apply_to_the_sources():
    """``scripts/torch_exact_split.py`` prices each piece of the by-slot
    kernels with copies of the sources that take it out; every copy's text
    is still in the sources, and each differs from the full one."""

    from scripts import torch_exact_split as split

    for name, variants in split.VARIANTS.items():
        full = split.variant_sources(name, [])
        for var, subs in variants.items():
            text = split.variant_sources(name, subs)
            assert (text == full) == (var == "full"), (name, var)

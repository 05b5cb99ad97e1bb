"""The tile and box rule of the three tricubic kernels (``csrc/tricubic.cu``),
on the CPU.

``tricubic.staged_tiles`` is the plain model of which output tiles the
kernels stage in shared memory (each subject's, for a cohort launch), and
``tricubic.warp_base`` the single-field displace's stencil base.  These tests pin the model on fields
whose counts can be worked out by hand, check that its constants are the
kernel's, and emulate both branches of the kernels step by step in numpy
float32 (the box copy with its periodic wrap, the per-point box offsets,
the running-sum contraction), which must equal the plain version bit for
bit.  The kernels themselves run only on a card
(``tests/test_torch_cuda.py``).
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "bench_torch"))
from fmad_ab import smooth_disp  # noqa: E402
from repro_torch.kernels import build, ref, tricubic  # noqa: E402

T1, T2, T3 = tricubic.TILE
W, R = tricubic.BOX_WIDTH, tricubic.BOX_ROWS


def _constant(shape, value):
    return torch.full((3,) + shape, value, dtype=torch.int32)


def _smooth(shape, max_disp, offset=0.0, seed=0):
    """(3, N..) f32: a uniform shift of ``offset`` voxels plus periodic low
    modes of at most ``max_disp`` voxels (``fmad_ab.smooth_disp``)."""
    return offset + smooth_disp(shape, max_disp, torch.Generator().manual_seed(seed), "cpu")


def test_constants_are_the_kernels():
    src = build.SOURCES[0].read_text()
    got = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (got["kTile1"], got["kTile2"], got["kTile3"]) == tricubic.TILE
    assert got["kBoxWidth"] == tricubic.BOX_WIDTH
    assert got["kBoxRows"] == tricubic.BOX_ROWS
    warp_rows = got["kWarpBoxRows"]
    assert warp_rows == tricubic.WARP_BOX_ROWS
    assert tricubic.BOX_ROWS_OF == {"tricubic_apply": R, "tricubic_displace_many": R,
                                    "tricubic_displace": warp_rows}
    # each kernel's box buffers, row offsets, column offsets and the block's
    # reduction stay within the static 48 KB: two buffers for K1/K2, one of
    # the taller box for K3
    for buffers, rows in ((2, R), (1, warp_rows)):
        assert (buffers * W * rows + rows + W + 6 * T2) * 4 <= 48 * 1024
    # the ladder's coarsest 256^3 level (64^3) still gives a wave of 132 SMs
    assert tricubic.n_tiles((64, 64, 64)) >= 132


@pytest.mark.parametrize("shape", [(64, 64, 64), (40, 48, 36), (12, 20, 9), (3, 5, 7)])
def test_zero_displacement_stages_every_tile(shape):
    base = _constant(shape, 0)
    assert tricubic.staged_tiles(base) == tricubic.n_tiles(shape)
    ext = tricubic.tile_extents(base)
    # a full tile spans its own points plus the stencil's 3 voxels
    assert ext[:, 0, 0, 0].tolist() == [min(t, n) + 3 for t, n in zip(tricubic.TILE, shape)]


@pytest.mark.parametrize("shape", [(64, 64, 64), (40, 48, 36)])
def test_constant_shift_that_wraps_stages_every_tile(shape):
    assert tricubic.staged_tiles(_constant(shape, 100)) == tricubic.n_tiles(shape)
    assert tricubic.staged_tiles(_constant(shape, -100)) == tricubic.n_tiles(shape)


@pytest.mark.parametrize("shape", [(64, 64, 64), (40, 48, 36), (12, 20, 9)])
def test_random_displacement_stages_none(shape):
    rng = np.random.default_rng(0)
    d = rng.uniform(-12, 12, (3,) + shape).astype(np.float32)
    assert tricubic.staged_tiles(torch.floor(torch.from_numpy(d)).to(torch.int32)) == 0


def test_smooth_shifted_field_stages_nearly_all_tiles():
    """A 10-voxel shift that wraps plus a smooth wave of at most 2 voxels
    (strain below 0.1, like a transport step's departure field) on 128^3:
    at least 95% of the tiles stage; the shift alone stages all."""
    shape = (128, 128, 128)
    d = _smooth(shape, 2.0, offset=10.0)
    assert float(d.abs().max()) <= 12.0
    staged = tricubic.staged_tiles(torch.floor(d).to(torch.int32))
    assert staged >= 0.95 * tricubic.n_tiles(shape)
    assert tricubic.staged_tiles(_constant(shape, 10)) == tricubic.n_tiles(shape)


@pytest.mark.parametrize("shape", [(40, 48, 36), (12, 20, 9)])
def test_cohort_stages_each_subjects_tiles(shape):
    """A cohort launch stages each subject's tile as a single-subject launch
    on that subject's bases would: subjects that stage every tile (no
    displacement), none (random) and most (smooth), counted together; and
    a launch over S subjects books S times the tiles."""
    rng = np.random.default_rng(0)
    random = torch.floor(torch.from_numpy(
        rng.uniform(-12, 12, (3,) + shape).astype(np.float32))).to(torch.int32)
    smooth = torch.floor(_smooth(shape, 4.0)).to(torch.int32)
    subjects = [_constant(shape, 0), random, smooth]
    cohort = torch.stack(subjects)
    singles = [tricubic.staged_tiles(b) for b in subjects]
    assert singles[0] == tricubic.n_tiles(shape) and singles[1] == 0
    assert tricubic.staged_tiles(cohort) == sum(singles)
    assert tricubic.staged_tiles(cohort, tricubic.WARP_BOX_ROWS) == sum(
        tricubic.staged_tiles(b, tricubic.WARP_BOX_ROWS) for b in subjects)
    d = torch.stack([b.to(torch.float32) + 0.25 for b in subjects])
    plan = ref.make_interp_plan(d)
    for name in ("tricubic_apply", "tricubic_displace_many"):
        base = tricubic.stencil_base(name, d, plan)
        assert base.shape == (3, 3) + shape
        assert tricubic.staged_tiles(base) == sum(singles)
    with tricubic.count_staged() as counts:
        tricubic._path_counter("tricubic_apply", shape, "cpu", len(subjects))
        tricubic._path_counter("tricubic_apply", shape, "cpu")
    assert counts == {("tricubic_apply", shape): {"staged": 0,
                                                  "tiles": 4 * tricubic.n_tiles(shape)}}


def test_ragged_edge_counts():
    """(40, 48, 36): 10 x 6 x 2 tiles, the second along x3 holding 4 points.
    A ragged tile spans 4 + 3 voxels along x3 and stages up to a stencil
    base 33 voxels further at its last point (4 + 33 + 3 = 40), not 34."""
    shape = (40, 48, 36)
    assert tricubic.n_tiles(shape) == 120
    base = _constant(shape, 0)
    base[2, :, :, 35] = 33
    assert tricubic.staged_tiles(base) == 120
    base[2, :, :, 35] = 34
    assert tricubic.staged_tiles(base) == 60
    # the first x3 tile: a base of -10 at x3 = 0 spans 10 + 32 + 3 > 40
    base = _constant(shape, 0)
    base[2, :, :, 0] = -10
    assert tricubic.staged_tiles(base) == 60
    # points beyond the ragged edge do not count: N2 = 44 leaves the rows
    # 40..43 in the last x2 tile; with a base of -3 at row 43 its stencils
    # start at 39..41, so the tile spans 41 - 39 + 4 = 6 rows, not the 11
    # that rows 44..47 would add
    shape = (40, 44, 36)
    base = _constant(shape, 0)
    base[1, :, 43, :] = -3
    assert tricubic.tile_extents(base)[1, 0, -1, 0] == 6
    assert tricubic.staged_tiles(base) == tricubic.n_tiles(shape)


def test_rows_budget_boundary():
    """One tile (4, 8, 32): 7 x 11 rows at rest; 8 x 18 = 144 rows stage,
    8 x 19 = 152 do not."""
    shape = (4, 8, 32)
    base = _constant(shape, 0)
    base[0, 3, 0, 0] = 1
    base[1, 0, 7, 0] = 7
    assert tricubic.tile_extents(base)[:2, 0, 0, 0].tolist() == [8, 18]
    assert tricubic.staged_tiles(base) == 1
    base[1, 0, 7, 0] = 8
    assert tricubic.staged_tiles(base) == 0


def test_grid_smaller_than_one_tile():
    shape = (3, 5, 7)
    assert tricubic.n_tiles(shape) == 1
    assert tricubic.tile_extents(_constant(shape, 0))[:, 0, 0, 0].tolist() == [6, 8, 10]
    base = _constant(shape, 0)
    base[0, 2, 4, 6] = 20  # 6 + 20 rows along x1, times 8 along x2
    assert tricubic.staged_tiles(base) == 0
    base[0, 2, 4, 6] = 12  # 18 x 8 = 144
    assert tricubic.staged_tiles(base) == 1


def test_warp_base_is_the_floor_of_the_query_point():
    """K3's base is floor(x + disp) - x with x + disp rounded in f32 first:
    at x = 5 a displacement of -1e-8 rounds x + disp up to 5.0, so the base
    is 0 where home + floor(disp) would give 4; elsewhere the two agree."""
    shape = (6, 4, 3)
    rng = np.random.default_rng(1)
    d = rng.uniform(-7, 7, (3,) + shape).astype(np.float32)
    d[0, 5, 1, 2] = np.float32(-1e-8)
    d[2, 0, 0, 2] = np.float32(-1e-8)
    d[1, 2, 3, 0] = np.float32(3.0)
    home = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"))
    want = np.floor(home.astype(np.float32) + d).astype(np.int64) - home
    got = tricubic.warp_base(torch.from_numpy(d))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 5, 1, 2] == 0 and got[2, 0, 0, 2] == 0 and got[1, 2, 3, 0] == 3
    naive = np.floor(d).astype(np.int64)
    assert naive[0, 5, 1, 2] == -1 and naive[2, 0, 0, 2] == -1
    assert tricubic.stencil_base("tricubic_displace", torch.from_numpy(d)).equal(got)
    assert tricubic.stencil_base("tricubic_displace_many", torch.from_numpy(d)).equal(
        torch.from_numpy(naive.astype(np.int32)))


def test_warp_box_holds_taller_tiles():
    """K3's box holds 288 (x1, x2) rows: a tile of 8 x 19 = 152 rows, which
    K1/K2's box of 144 does not hold, stages in K3's; 8 x 37 = 296 in
    neither."""
    shape = (4, 8, 32)
    base = _constant(shape, 0)
    base[0, 3, 0, 0] = 1
    base[1, 0, 7, 0] = 8
    assert tricubic.staged_tiles(base) == 0
    assert tricubic.staged_tiles(base, tricubic.WARP_BOX_ROWS) == 1
    base[1, 0, 7, 0] = 25  # 8 x 36 = 288
    assert tricubic.staged_tiles(base, tricubic.WARP_BOX_ROWS) == 1
    base[1, 0, 7, 0] = 26
    assert tricubic.staged_tiles(base, tricubic.WARP_BOX_ROWS) == 0


def test_count_staged_books_tiles_by_kernel_and_grid():
    """Inside count_staged() each launch adds its tiles to its kernel and
    grid (the staged ones come from the kernel: none here, on the CPU);
    outside, no counter is handed to the kernel."""
    with tricubic.count_staged() as counts:
        with pytest.raises(RuntimeError):
            with tricubic.count_staged():
                pass
        for shape in ((40, 48, 36), (40, 48, 36), (12, 20, 9)):
            assert tricubic._path_counter("tricubic_apply", shape, "cpu") is not None
        tricubic._path_counter("tricubic_displace_many", (12, 20, 9), "cpu")
        assert counts == {}
    assert counts == {
        ("tricubic_apply", (40, 48, 36)): {"staged": 0, "tiles": 240},
        ("tricubic_apply", (12, 20, 9)): {"staged": 0, "tiles": 9},
        ("tricubic_displace_many", (12, 20, 9)): {"staged": 0, "tiles": 9},
    }
    assert tricubic._path_counter("tricubic_apply", (12, 20, 9), "cpu") is None


def test_count_staged_books_the_single_field_displace():
    """The single-field displace books its launches under its own key,
    apart from the batched displace on the same grid, by grid shape."""
    with tricubic.count_staged() as counts:
        for shape in ((64, 64, 64), (40, 48, 36), (40, 48, 36)):
            assert tricubic._path_counter("tricubic_displace", shape, "cpu") is not None
        tricubic._path_counter("tricubic_displace_many", (40, 48, 36), "cpu")
    assert counts == {
        ("tricubic_displace", (64, 64, 64)): {"staged": 0, "tiles": 16 * 8 * 2},
        ("tricubic_displace", (40, 48, 36)): {"staged": 0, "tiles": 2 * 120},
        ("tricubic_displace_many", (40, 48, 36)): {"staged": 0, "tiles": 120},
    }


# --------------------------------------------------------------------------- #
# the kernels' two branches, step by step in numpy float32
# --------------------------------------------------------------------------- #
def _contract_run(at, w):
    """csrc/tricubic.cu contract_run: d outer, b middle, a inner."""
    out = None
    for d in range(4):
        acc = None
        for b in range(4):
            s = at(0, b, d) * w[0, 0]
            for a in range(1, 4):
                s = s + at(a, b, d) * w[0, a]
            acc = s * w[1, 0] if b == 0 else acc + s * w[1, b]
        out = acc * w[2, 0] if d == 0 else out + acc * w[2, d]
    return out


def _emulate(fields, ib, w, rows=R):
    """A kernel as it computes its output, tile by tile, for stencil bases
    ``ib`` (the stencil origin is x + ib - 1), weights ``w`` (3, 4, N..) and
    a box of ``rows`` (x1, x2) rows.  Returns the output and the number of
    staged tiles."""
    c, n1, n2, n3 = fields.shape
    flat = fields.reshape(c, -1)
    out = np.zeros_like(flat)
    staged = 0
    for x1_0 in range(0, n1, T1):
        for x2_0 in range(0, n2, T2):
            for x3_0 in range(0, n3, T3):
                xs = np.stack(np.meshgrid(np.arange(x1_0, min(x1_0 + T1, n1)),
                                          np.arange(x2_0, min(x2_0 + T2, n2)),
                                          np.arange(x3_0, min(x3_0 + T3, n3)),
                                          indexing="ij")).reshape(3, -1)
                q = (xs[0] * n2 + xs[1]) * n3 + xs[2]
                g = xs + ib.reshape(3, -1)[:, q] - 1
                wq = w.reshape(3, 4, -1)[:, :, q]
                lo, hi = g.min(axis=1), g.max(axis=1)
                e1, e2, e3 = hi - lo + 4
                if e3 <= W and e1 * e2 <= rows:
                    staged += 1
                    r = np.arange(e1 * e2)
                    j1 = r // e2
                    row_off = ((lo[0] + j1) % n1) * (n2 * n3) + ((lo[1] + r - j1 * e2) % n2) * n3
                    col_off = (lo[2] + np.arange(e3)) % n3
                    box = np.full((c, e1 * e2 * W), np.nan, dtype=np.float32)
                    e = np.arange(e1 * e2 * W)
                    row, j3 = e // W, e % W
                    keep = j3 < e3
                    box[:, e[keep]] = flat[:, row_off[row[keep]] + col_off[j3[keep]]]
                    o = ((g[0] - lo[0]) * e2 + (g[1] - lo[1])) * W + (g[2] - lo[2])
                    step1 = e2 * W

                    def at(a, b, d, box=box, o=o, step1=step1):
                        return box[:, o + a * step1 + b * W + d]
                else:
                    r1, r2, r3 = [[((g[k] + a) % n) * s for a in range(4)]
                                  for k, (n, s) in enumerate(((n1, n2 * n3), (n2, n3), (n3, 1)))]

                    def at(a, b, d, r1=r1, r2=r2, r3=r3):
                        return flat[:, r1[a] + r2[b] + r3[d]]
                out[:, q] = _contract_run(at, wq)
    return out.reshape(fields.shape), staged


@pytest.mark.parametrize("shape", [(12, 20, 36), (5, 9, 40)])
def test_emulated_kernel_branches_match_plain_bit_for_bit(rng, shape):
    """Smooth where x1 < 4 (those tiles stage), rough elsewhere (they gather
    from global memory): both branches, against ref.interp_apply."""
    f = rng.standard_normal((2,) + shape).astype(np.float32)
    d = _smooth(shape, 1.5, offset=-7.25).numpy()
    rough = rng.uniform(-9, 9, (3,) + shape).astype(np.float32)
    d[:, 4:] = rough[:, 4:]
    plan = ref.make_interp_plan(torch.from_numpy(d))
    want = ref.interp_apply(torch.from_numpy(f), plan).numpy()
    got, staged = _emulate(f, plan.ib.numpy().astype(np.int64), plan.w.numpy())
    assert 0 < staged < tricubic.n_tiles(shape)
    assert staged == tricubic.staged_tiles(plan.ib)
    np.testing.assert_array_equal(got, want)


def _lagrange_f32(t):
    """csrc/tricubic.cu lagrange(), each f32 operation rounded (numpy)."""
    sixth, half, one, two = (np.float32(x) for x in (1.0 / 6.0, 0.5, 1.0, 2.0))
    return np.stack([
        -t * (t - one) * (t - two) * sixth,
        (t + one) * (t - one) * (t - two) * half,
        -(t + one) * t * (t - two) * half,
        (t + one) * t * (t - one) * sixth,
    ])


def _warp_inputs(rng, shape):
    """One field and a displacement that is smooth (at most 3 voxels plus a
    shift of 30.5) where x1 < 4 and rough (+-20 voxels) elsewhere, with
    points whose x + disp rounds up to an integer in f32."""
    f = rng.standard_normal(shape).astype(np.float32)
    d = _smooth(shape, 3.0, offset=30.5).numpy()
    rough = rng.uniform(-20, 20, (3,) + shape).astype(np.float32)
    d[:, 4:] = rough[:, 4:]
    d[:, 1, 2, 3] = np.float32(-1e-8)  # x + disp rounds up to x
    d[:, 3, 4, 1] = np.float32(-1e-8)
    return f, d


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 20, 36), (5, 9, 40)])
def test_emulated_warp_branches_match_plain_bit_for_bit(rng, shape):
    """The single-field displace (K3) as the kernel computes it: q = x +
    disp in f32, the stencil origin floor(q) - 1, the weights lagrange(q -
    floor(q)), its taller box; staged tiles where x1 < 4, unstaged
    elsewhere: against ref.tricubic_displace, on a cubic, a non-cubic and a
    ragged grid."""
    f, d = _warp_inputs(rng, shape)
    want = ref.tricubic_displace(torch.from_numpy(f), torch.from_numpy(d)).numpy()
    home = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"))
    q = home.astype(np.float32) + d
    fl = np.floor(q)
    w = np.moveaxis(_lagrange_f32(q - fl), 0, 1)  # (3, 4, N..)
    base = fl.astype(np.int64) - home
    np.testing.assert_array_equal(base, tricubic.warp_base(torch.from_numpy(d)).numpy())
    got, staged = _emulate(f[None], base, w, tricubic.WARP_BOX_ROWS)
    assert 0 < staged < tricubic.n_tiles(shape)
    assert staged == tricubic.staged_tiles(tricubic.warp_base(torch.from_numpy(d)),
                                           tricubic.WARP_BOX_ROWS)
    np.testing.assert_array_equal(got[0], want)


def test_emulated_warp_needs_the_floor_of_the_query_point(rng):
    """Built from home + floor(disp) instead, the stencils of the points
    whose x + disp rounds up start one voxel too low: the staged box no
    longer gives the plain version's values there."""
    shape = (12, 20, 36)
    f, d = _warp_inputs(rng, shape)
    want = ref.tricubic_displace(torch.from_numpy(f), torch.from_numpy(d)).numpy()
    home = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"))
    q = home.astype(np.float32) + d
    w = np.moveaxis(_lagrange_f32(q - np.floor(q)), 0, 1)
    got, _ = _emulate(f[None], np.floor(d).astype(np.int64), w, tricubic.WARP_BOX_ROWS)
    wrong = got[0] != want
    assert wrong[1, 2, 3] and wrong[3, 4, 1]


class _Op:
    """A value that books each distinct f32 operation made from it in
    ``ops`` (a common subexpression once, as the compiler issues it);
    negation is a sign modifier of the product that takes it, not an
    operation."""

    __array_ufunc__ = None  # numpy scalars defer to the reflected operators

    def __init__(self, key, ops):
        self.key, self.ops = key, ops

    def _op(self, name, other, reflected=False):
        other_key = other.key if isinstance(other, _Op) else ("const", float(other))
        key = (name, other_key, self.key) if reflected else (name, self.key, other_key)
        self.ops.add(key)
        return _Op(key, self.ops)

    def __add__(self, other):
        return self._op("+", other)

    def __sub__(self, other):
        return self._op("-", other)

    def __mul__(self, other):
        return self._op("*", other)

    def __radd__(self, other):
        return self._op("+", other, True)

    def __rmul__(self, other):
        return self._op("*", other, True)

    def __neg__(self):
        return _Op(("neg", self.key), self.ops)


@pytest.mark.parametrize("name,c", [("tricubic_apply", 2), ("tricubic_displace_many", 3),
                                    ("tricubic_displace", 1)])
def test_chip_smoke_counts_the_kernels_operations(name, c):
    """The operations chip_smoke.py's bounds divide by are those of the
    contraction and the Lagrange weights as the kernels do them: 147 per
    channel, and per axis lagrange() plus floor and a subtraction (and the
    single-field displace's sum q = x + disp)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    ops = set()
    values = {(a, b, d): _Op(("at", a, b, d), ops)
              for a in range(4) for b in range(4) for d in range(4)}
    w = np.empty((3, 4), dtype=object)
    for ax, k in np.ndindex(3, 4):
        w[ax, k] = _Op(("w", ax, k), ops)
    _contract_run(lambda a, b, d: values[(a, b, d)], w)
    per_channel = len(ops)
    ops.clear()
    _lagrange_f32(_Op("t", ops))
    per_axis = len(ops) + 2 + (name == "tricubic_displace")  # floor, subtraction, q
    weights = 0 if name == "tricubic_apply" else 3 * per_axis
    assert (per_channel, len(ops)) == (147, 15)
    npts = 5
    assert chip_smoke._tile_bytes_flops(name, c, npts)[1] == (per_channel * c + weights) * npts

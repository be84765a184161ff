"""Host-side pieces of the cell GEMM's tiling: the tile constants read from
``csrc/cell_gemm.cuh``, the scratch the wrappers allocate for each precision
profile, the re-laid U (``lstm_cell.relaid_u``) that the bf16 kernels
read, at the per-step cell's width and at the serving rollout's wider one,
held to the plain cell in float64, and the cell operands every kernel takes
(``lstm_cell.cell_operands``, the rollout's ``prepare_rollout``)."""

import numpy as np
import pytest
import torch

from iadmm_tpu_torch.kernels import _build
from iadmm_tpu_torch.kernels import lstm_cell as lc
from iadmm_tpu_torch.kernels import rollout_kernel as troll
from iadmm_tpu_torch.kernels import train_rollout as ttr

PROFILES = ("bfloat16", "float32")
WIDTHS = (16, 20, 24, 32, 44, 800, 808)
ROLLOUT_WIDTHS = (212, 800, 808)   # the rollout's flagship and ragged h


def test_tile_constants():
    """The tile constants the scratch and Ut are sized from: both profiles'
    cell tiles are 128 x 128 (4 gates of 32 units: h = 800 is 25 tiles, so
    H is read 25 times), the bf16 one the wgmma core's; delta's partials
    are one per 16 units on both profiles, and so are the float32
    backward's row partials (one per unit tile for bf16)."""
    assert _build.CELL_BM == 128
    assert _build.CELL_HB == {"bfloat16": 32, "float32": 32}
    assert 4 * _build.CELL_HB["bfloat16"] == _build.header_int("hopper.cuh",
                                                               "BN")
    assert _build.DELTA_HB == 16 and _build.UT_ALIGN == 8
    assert _build.cell_tiles(800, "bfloat16") == 25
    assert _build.cell_tiles(800, "float32") == 25
    assert _build.delta_partials(800) == 50
    assert _build.row_partials(800, "bfloat16") == 25
    assert _build.row_partials(800, "float32") == 50
    for h in WIDTHS:
        for gate in PROFILES:
            assert _build.cell_tiles(h, gate) == -(-h // 32)
        assert _build.row_partials(h, "bfloat16") == -(-h // 32)
        assert _build.row_partials(h, "float32") == -(-h // 16)


@pytest.mark.parametrize("h", WIDTHS)
def test_cell_scratch(h):
    """The delta partials: one float32 row of M per 16 hidden units."""
    M = 2 * 1037
    part = lc.cell_scratch(M, h, "cpu")
    assert part.shape == (-(-h // 16), M) and part.dtype == torch.float32


@pytest.mark.parametrize("cdt", PROFILES)
@pytest.mark.parametrize("h", WIDTHS)
def test_train_scratch_per_profile(cdt, h):
    """The training pair's scratch, in the entry points' order: the
    forward's two KKT passes' partials and row dots (the second carries
    the pending loss), its loss vectors (J + 1 slabs) and its delta
    partials (one row per 16 units), the backward's row
    partials (pg: one row per 32-unit tile for bf16, per 16 units for
    float32; pxv, also the segment backward's delta scratch: one per 16
    units), column partials (pdb, pdw0, pdw1, pdwh: one row per 128-token
    tile), dpre in the compute dtype and, for float32, dpre transposed
    (the float32 dH's operand; one element for bf16)."""
    B, n, m = 2, 300, 237
    S, M = n + m, B * (n + m)
    n_rp = -(-h // {"bfloat16": 32, "float32": 16}[cdt])
    n_dp = -(-h // 16)
    n_mt = -(-M // 128)
    J = 3
    fwd = ttr._fwd_scratch(B, n, m, h, J, "cpu")
    assert [tuple(t.shape) for t in fwd] == [
        (B, S), (B, S), (B, -(-S // 32), n), (B, m), (B, -(-S // 32), n),
        (B, m), (J + 1, B, S), (n_dp, M)]
    bwd = ttr._bwd_scratch(B, n, m, h, cdt, "cpu")
    dpre_t = (4 * h, M) if cdt == "float32" else (1,)
    assert [tuple(t.shape) for t in bwd] == (
        [(B, S)] * 6 + [(B, m), (B, n), (1,), (B, -(-S // 32), n), (B, m),
                        (M, 4 * h), dpre_t, (n_dp, M), (n_rp, M),
                        (n_mt, 4 * h), (n_mt, 4 * h), (n_mt, 4 * h),
                        (n_mt, h)])
    assert bwd[11].dtype == ttr._CDT[cdt]
    assert bwd[12].dtype == torch.float32


def _column_map(h, hb=None):
    """Row of Ut holding column c = g·h + u of U, for tiles of ``hb`` units
    (the per-step cell's by default)."""
    hb = hb or _build.CELL_HB["bfloat16"]
    g, u = np.divmod(np.arange(4 * h), h)
    return (u // hb) * 4 * hb + g * hb + u % hb


@pytest.mark.parametrize("h", WIDTHS)
def test_relaid_u_inverts(h):
    """Every column of U lands on its own row of Ut (the column map is one
    to one), the padding is zero, and reading the map back gives U."""
    rng = np.random.default_rng(h)
    U = torch.from_numpy(rng.standard_normal((h, 4 * h)))
    Ut = lc.relaid_u(U, h)
    nt = _build.cell_tiles(h, "bfloat16")
    ld = -(-h // 8) * 8
    assert Ut.shape == (nt * 128, ld) and Ut.dtype == U.dtype
    rows = _column_map(h)
    assert len(set(rows.tolist())) == 4 * h
    torch.testing.assert_close(Ut[rows, :h].T, U, rtol=0, atol=0)
    pad = np.ones(Ut.shape[0], bool)
    pad[rows] = False
    assert not Ut[pad].any() and not Ut[:, h:].any()


@pytest.mark.parametrize("h,S", [(20, 37), (44, 133), (64, 40)])
def test_cell_over_relaid_u_matches_plain(h, S):
    """A plain cell whose gate GEMM reads Ut through the column map equals
    ``cell_plain`` in float64."""
    rng = np.random.default_rng(7)
    f64 = torch.float64

    def rand(*shape, s=1.0):
        return torch.from_numpy(s * rng.standard_normal(shape)).to(f64)
    W, U, b = rand(2, 4 * h, s=0.1), rand(h, 4 * h, s=0.3), rand(4 * h)
    W_h, b_h = rand(h, 1, s=0.1), rand(1)
    x, H, C = rand(2, S, 2), torch.tanh(rand(2, S, h)), rand(2, S, h)
    Ut = lc.relaid_u(U, h)
    gates = (x @ W + (H @ Ut[:, :h].T)[..., _column_map(h)] + b)
    i, f, o = (torch.sigmoid(gates[..., k * h:(k + 1) * h])
               for k in range(3))
    u = torch.tanh(gates[..., 3 * h:])
    C_new = i * u + f * C
    H_new = o * torch.tanh(C_new)
    delta = (H_new @ W_h)[..., 0] + b_h
    ref = lc.cell_plain(W, U, b, W_h, b_h, x, H, C, "float32")
    for a, r in zip((delta, H_new, C_new), ref):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)


def test_rollout_tile_constants():
    """The serving rollout's own cell tile: HB_ROLLOUT = 64 units of all
    four gates (128 x 256, two n128 blocks of the core), CL_ROLLOUT = 2
    CTAs a cluster; h = 800 is 13 unit tiles, so H is read 13 times, not
    25.  Delta's partials stay one per 16 units, and the backward's tile
    stays HB_BF16 = 32 (its row partials are one per unit tile)."""
    assert _build.ROLLOUT_HB == _build.header_int("cell_gemm.cuh",
                                                  "HB_ROLLOUT") == 64
    assert _build.ROLLOUT_CLUSTER == _build.header_int("cell_gemm.cuh",
                                                       "CL_ROLLOUT") == 2
    assert 4 * _build.ROLLOUT_HB % _build.header_int("hopper.cuh", "BN") == 0
    assert _build.ROLLOUT_HB % _build.DELTA_HB == 0
    assert _build.CELL_HB["bfloat16"] == 32
    assert _build.cell_tiles(800, hb=_build.ROLLOUT_HB) == 13
    assert _build.row_partials(800, "bfloat16") == 25
    for h in WIDTHS + ROLLOUT_WIDTHS:
        assert _build.cell_tiles(h, hb=64) == -(-h // 64)
        assert _build.ut_ld(h) == -(-h // 8) * 8


@pytest.mark.parametrize("h", ROLLOUT_WIDTHS)
def test_relaid_u_inverts_at_the_rollout_width(h):
    """``relaid_u(U, h, hb)`` at the rollout's width: every column of U on
    its own row of Ut, 4·64 rows a unit tile, zero padding, and the column
    map read back gives U."""
    hb = _build.ROLLOUT_HB
    rng = np.random.default_rng(h)
    U = torch.from_numpy(rng.standard_normal((h, 4 * h)))
    Ut = lc.relaid_u(U, h, hb)
    nt = _build.cell_tiles(h, hb=hb)
    assert Ut.shape == (nt * 4 * hb, _build.ut_ld(h)) and Ut.dtype == U.dtype
    rows = _column_map(h, hb)
    assert len(set(rows.tolist())) == 4 * h
    torch.testing.assert_close(Ut[rows, :h].T, U, rtol=0, atol=0)
    pad = np.ones(Ut.shape[0], bool)
    pad[rows] = False
    assert not Ut[pad].any() and not Ut[:, h:].any()
    # one unit tile's four gates are 4·hb consecutive rows of Ut
    g, u = np.divmod(np.arange(4 * h), h)
    assert (rows // (4 * hb) == u // hb).all()
    assert (rows % (4 * hb) == g * hb + u % hb).all()


@pytest.mark.parametrize("h,S", [(212, 37), (808, 9), (72, 133)])
def test_cell_over_rollout_ut_matches_plain(h, S):
    """A plain cell whose gate GEMM reads the rollout's wide Ut through its
    column map equals ``cell_plain`` in float64."""
    rng = np.random.default_rng(h + S)
    f64 = torch.float64
    hb = _build.ROLLOUT_HB

    def rand(*shape, s=1.0):
        return torch.from_numpy(s * rng.standard_normal(shape)).to(f64)
    W, U, b = rand(2, 4 * h, s=0.1), rand(h, 4 * h, s=0.3), rand(4 * h)
    W_h, b_h = rand(h, 1, s=0.1), rand(1)
    x, H, C = rand(2, S, 2), torch.tanh(rand(2, S, h)), rand(2, S, h)
    Ut = lc.relaid_u(U, h, hb)
    gates = (x @ W + (H @ Ut[:, :h].T)[..., _column_map(h, hb)] + b)
    i, f, o = (torch.sigmoid(gates[..., k * h:(k + 1) * h])
               for k in range(3))
    u = torch.tanh(gates[..., 3 * h:])
    C_new = i * u + f * C
    H_new = o * torch.tanh(C_new)
    delta = (H_new @ W_h)[..., 0] + b_h
    ref = lc.cell_plain(W, U, b, W_h, b_h, x, H, C, "float32")
    for a, r in zip((delta, H_new, C_new), ref):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)


def test_rollout_tile_shared_memory():
    """The rollout tile's shared memory, as ``RolloutShape::SMEM`` adds it
    up from the header's constants, fits the H100's 232,448 bytes a block:
    1024 bytes of alignment, 3 ring stages of a 128-row A box and 4·HB Ut
    columns (bf16, BK deep) with two 8-byte barriers each, two weight
    buffers of WS floats a unit, two buffers of the tile's C entries (rows
    of HB + 4 floats) and their four 8-byte barriers."""
    hdr = "cell_gemm.cuh"
    bm, bk = (_build.header_int("hopper.cuh", k) for k in ("BM", "BK"))
    hb, ws = _build.ROLLOUT_HB, _build.header_int(hdr, "WS")
    stages = _build.header_int(hdr, "S")
    text = (_build.CSRC / hdr).read_text()
    assert "static constexpr int CLD = HB_ROLLOUT + 4;" in text
    smem = (1024 + stages * (bm * bk * 2 + 4 * hb * bk * 2) + 2 * stages * 8
            + 2 * ws * hb * 4 + 2 * bm * (hb + 4) * 4 + 4 * 8)
    assert (stages, ws, smem) == (3, 20, 228432)
    assert smem <= 232448


def _cell_weights(h, seed=3):
    g = torch.Generator().manual_seed(seed)
    shapes = dict(W=(2, 4 * h), U=(h, 4 * h), b=(4 * h,), W_h=(h, 1),
                  b_h=(1,))
    return {k: torch.randn(s, generator=g) for k, s in shapes.items()}


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("gate", PROFILES)
@pytest.mark.parametrize("h,hb", [(20, None), (44, None), (212, 64)])
def test_cell_operands(h, hb, gate, backward):
    """``cell_operands`` gives, for both gate dtypes, forward and backward,
    at the per-step cell's tile and the rollout's: W, U and W_h in the gate
    dtype (W_h flattened), b and b_h in float32, all contiguous, U 16-byte
    aligned; Ut is U re-laid for the tile (bf16), U itself (float32
    forward) or Uᵀ (float32 backward), bitwise."""
    w = _cell_weights(h)
    wdt = ttr._CDT[gate]
    kw = dict(hb=hb) if hb else {}
    ops = lc.cell_operands(*(w[k] for k in lc.CELL_KEYS), h=h,
                           gate_dtype=gate, backward=backward, **kw)
    U = w["U"].to(wdt)
    if gate == "bfloat16":
        Ut = lc.relaid_u(U, h, hb or _build.CELL_HB["bfloat16"])
    else:
        Ut = U.t() if backward else U
    want = dict(W=w["W"].to(wdt), U=U, Ut=Ut, b=w["b"],
                W_h=w["W_h"].reshape(-1).to(wdt), b_h=w["b_h"])
    for k, t in want.items():
        got = getattr(ops, k)
        assert got.dtype == t.dtype and got.is_contiguous(), k
        assert torch.equal(got, t), k
    assert ops.U.data_ptr() % 16 == 0


def test_cell_operands_reject_bad_weights():
    """A weight of the wrong shape is named; an unknown gate dtype and
    weights on two devices are refused."""
    w = _cell_weights(16)
    for k, bad in (("'U'", w["U"][:, :-4]), ("'b_h'", w["b_h"][:0])):
        args = dict(w, **{k.strip("'"): bad})
        with pytest.raises(ValueError, match=k):
            lc.cell_operands(*(args[c] for c in lc.CELL_KEYS), h=16,
                             gate_dtype="bfloat16")
    with pytest.raises(ValueError, match="gate dtype"):
        lc.cell_operands(*w.values(), h=16, gate_dtype="float16")
    meta = dict(w, b=w["b"].to("meta"))
    with pytest.raises(ValueError, match="one device"):
        lc.cell_operands(*(meta[c] for c in lc.CELL_KEYS), h=16,
                         gate_dtype="float32")


def test_prepare_rollout():
    """The rollout's weights: the bf16 cell operands at the rollout's tile
    and rho, alpha in float32; prepared weights pass through unchanged
    where they fit h and K, and are refused where they do not."""
    h, K = 20, 6
    params = dict(_cell_weights(h), rho=torch.randn(K).double(),
                  alpha=torch.randn(K + 2))
    wts = troll.prepare_rollout(params, hidden=h, K=K)
    ops = lc.cell_operands(*(params[k] for k in lc.CELL_KEYS), h=h,
                           gate_dtype="bfloat16", hb=_build.ROLLOUT_HB)
    for a, b in zip(wts.cell, ops):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k in ("rho", "alpha"):
        t = getattr(wts, k)
        assert t.dtype == torch.float32 and torch.equal(t, params[k].float())
    assert troll.prepare_rollout(wts, hidden=h, K=K) is wts
    for kw in (dict(hidden=h + 1, K=K), dict(hidden=h, K=K + 1)):
        with pytest.raises(ValueError, match="do not fit"):
            troll.prepare_rollout(wts, **kw)
    with pytest.raises(ValueError, match="lack"):
        troll.prepare_rollout({k: params[k] for k in lc.CELL_KEYS},
                              hidden=h, K=K)
    with pytest.raises(ValueError, match="rollout needs"):
        troll.prepare_rollout(params, hidden=h, K=K + 1)

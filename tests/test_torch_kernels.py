"""repro_torch's kernels: the plain versions against the JAX Pallas
kernels (interpret mode) and the JAX refs, and the dispatch rules. The
CUDA kernels are held against the plain versions in test_torch_cuda.py,
on a GPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.edge_score import edge_score as jax_edge_score
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.gcn_agg import gcn_agg as jax_gcn_agg
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import edge_score as edge_mod
from repro_torch.kernels import gcn_agg as gcn_mod
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

# f32, the tolerance of tests/test_kernels.py's actor-path kernels
TOL = dict(rtol=1e-5, atol=1e-5)
ACTOR_SHAPES = [(b, m, o) for b in (1, 64) for m in (5, 14)
                for o in (6, 12)]
# (M, O, Fs, Fn, H) of the four gcn_agg launches of one actor forward at
# the paper's width (core/gcn.py): device then option side, layers 1 and 2
SLICE_GCN = [(14, 10, 7, 4, 128), (10, 14, 4, 7, 128),
             (14, 10, 128, 128, 64), (10, 14, 128, 128, 64)]
# tests/test_kernels.py's attention grids and tolerances
ATTN_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}
FLASH_GRID = [(1, 128, 2, 2, 32, None), (2, 128, 4, 2, 64, None),
              (1, 256, 8, 2, 32, 64), (2, 64, 4, 1, 128, None)]
DECODE_GRID = [(2, 4, 2, 32, 256), (3, 8, 2, 64, 512), (1, 2, 2, 128, 128)]
# (B, H, KVH, d, S, splits, lengths) for the split-KV plain version: empty
# splits (lengths 1 and 5 under 8 splits), lengths 0, 1 and > S, and split
# boundaries inside a length (130 rows in 3 splits of 44)
SPLIT_CASES = [(4, 4, 2, 32, 256, 3, (0, 1, 300, 130)),
               (3, 8, 2, 64, 512, 8, (5, 512, 1)),
               (2, 2, 2, 128, 128, 1, (128, 0)),
               (1, 4, 1, 64, 256, 5, (257,)),
               (2, 8, 2, 32, 128, 7, (100, 13))]


def gcn_args(seed, b, m, o, fs=7, fn=4, h=16):
    rng = np.random.default_rng(seed)
    adj = (rng.uniform(size=(b, m, o)) * (rng.uniform(size=(b, m, o)) > 0.3))
    arrays = (adj, rng.normal(size=(b, m, fs)), rng.normal(size=(b, o, fn)),
              rng.normal(size=(fs, h)), rng.normal(size=(fn, h)),
              rng.normal(size=(h,)))
    return tuple(a.astype(np.float32) for a in arrays)


def edge_args(seed, b, m, o, h=9, e=11):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(b, m, h)), rng.normal(size=(b, o, h)),
              rng.uniform(size=(b, m, o)), rng.normal(size=(h, e)),
              rng.normal(size=(e,)), rng.normal(size=(h, e)),
              rng.normal(size=(e,)), rng.normal(size=(e,)),
              rng.normal(size=(1,)))
    return tuple(a.astype(np.float32) for a in arrays)


def to_torch(args, device="cpu"):
    return tuple(torch.tensor(a, device=device) for a in args)


@pytest.mark.parametrize("b,m,o", ACTOR_SHAPES)
def test_gcn_agg_ref_matches_pallas(b, m, o):
    args = gcn_args(b * 100 + m * 10 + o, b, m, o)
    want = jax_gcn_agg(*map(jnp.asarray, args), interpret=True)
    got = ref.gcn_agg_ref(*to_torch(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,o,fs,fn,h", SLICE_GCN)
def test_gcn_agg_ref_matches_pallas_slice_shapes(m, o, fs, fn, h):
    args = gcn_args(fs + fn + h, 3, m, o, fs, fn, h)
    want = jax_gcn_agg(*map(jnp.asarray, args), interpret=True)
    got = ref.gcn_agg_ref(*to_torch(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,m,o", ACTOR_SHAPES)
def test_edge_score_ref_matches_pallas(b, m, o):
    args = edge_args(b * 100 + m * 10 + o, b, m, o)
    want = jax_edge_score(*map(jnp.asarray, args), interpret=True)
    got = ref.edge_score_ref(*to_torch(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_edge_score_ref_matches_pallas_slice_shape():
    args = edge_args(7, 3, 14, 10, h=64, e=64)
    want = jax_edge_score(*map(jnp.asarray, args), interpret=True)
    got = ref.edge_score_ref(*to_torch(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------- dispatch
def test_ops_on_cpu_runs_plain_version_and_launches_nothing():
    ops.reset_launch_counts()
    g_args = to_torch(gcn_args(0, 2, 5, 6))
    e_args = to_torch(edge_args(0, 2, 5, 6))
    assert torch.equal(ops.gcn_agg(*g_args), ref.gcn_agg_ref(*g_args))
    assert torch.equal(ops.edge_score(*e_args), ref.edge_score_ref(*e_args))
    assert ops.launch_counts() == {"gcn_agg": 0, "edge_score": 0,
                                   "flash_attention": 0,
                                   "decode_attention": 0, "ssm_scan": 0}


def test_ops_strided_adjacency_on_cpu():
    """The option-side layer passes a transposed adjacency view."""
    adj, hs, hn, ws, wn, b = to_torch(gcn_args(1, 2, 6, 5))
    adj_t = adj.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not adj_t.is_contiguous() and torch.equal(adj_t, adj)
    np.testing.assert_allclose(
        ops.gcn_agg(adj_t, hs, hn, ws, wn, b).numpy(),
        ref.gcn_agg_ref(adj, hs, hn, ws, wn, b).numpy(),
        rtol=1e-6, atol=1e-6)


def attn_args(seed, b, s, h, kvh, d, dtype="float32", decode=False):
    """numpy-drawn q/k/v (and lengths in [1, S] for decode) as JAX and as
    torch arrays, both rounded to ``dtype`` from the same float32 bits."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d) if decode else (b, s, h, d))
    k = rng.standard_normal((b, s, kvh, d))
    v = rng.standard_normal((b, s, kvh, d))
    arrays = [a.astype(np.float32) for a in (q, k, v)]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]
    if decode:
        lens = rng.integers(1, s + 1, size=(b,)).astype(np.int32)
        jx.append(jnp.asarray(lens))
        tx.append(torch.tensor(lens))
    return jx, tx


def as_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kvh,d,win", FLASH_GRID)
def test_flash_attention_ref_matches_pallas_and_jax_ref(dtype, b, s, h, kvh,
                                                        d, win):
    (jq, jk, jv), (q, k, v) = attn_args(s + h + d, b, s, h, kvh, d, dtype)
    got = ref.flash_attention_ref(q, k, v, window=win)
    assert got.dtype == q.dtype and got.shape == q.shape
    for want in (jax_flash(jq, jk, jv, window=win, block_q=64, block_k=64),
                 jax_ref.flash_attention_ref(jq, jk, jv, window=win)):
        np.testing.assert_allclose(as_f32(got), as_f32(want),
                                   **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,d,s", DECODE_GRID)
def test_decode_attention_ref_matches_pallas_and_jax_ref(dtype, b, h, kvh, d,
                                                         s):
    jx, tx = attn_args(s + h + d, b, s, h, kvh, d, dtype, decode=True)
    got = ref.decode_attention_ref(*tx)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    for want in (jax_decode(*jx, block_k=128),
                 jax_ref.decode_attention_ref(*jx)):
        np.testing.assert_allclose(as_f32(got), as_f32(want),
                                   **ATTN_TOL[dtype])


def test_flash_attention_ref_non_causal_and_ragged_length():
    """The port's kernel takes any S (the TPU kernel needs S % block == 0)
    and causal=False; the plain version agrees with the JAX ref there."""
    (jq, jk, jv), (q, k, v) = attn_args(3, 2, 100, 4, 2, 64)
    for causal in (True, False):
        np.testing.assert_allclose(
            as_f32(ops.flash_attention(q, k, v, causal=causal)),
            as_f32(jax_ref.flash_attention_ref(jq, jk, jv, causal=causal)),
            **ATTN_TOL["float32"])


def test_attention_ops_on_cpu_run_plain_versions():
    ops.reset_launch_counts()
    _, (q, k, v) = attn_args(0, 2, 64, 4, 2, 32)
    assert torch.equal(ops.flash_attention(q, k, v, window=16),
                       ref.flash_attention_ref(q, k, v, window=16))
    _, dx = attn_args(1, 2, 64, 4, 2, 32, decode=True)
    assert torch.equal(ops.decode_attention(*dx),
                       ref.decode_attention_ref(*dx))
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("op", ["flash_attention", "decode_attention"])
def test_attention_wrappers_refuse_bad_shapes_and_devices(op):
    decode = op == "decode_attention"
    fn = getattr(ops, op)
    _, args = attn_args(0, 1, 64, 3, 2, 32, decode=decode)   # 3 % 2 != 0
    with pytest.raises(ValueError, match="do not split"):
        fn(*args)
    _, args = attn_args(0, 1, 64, 4, 2, 32, decode=decode)
    with pytest.raises(ValueError, match="must be"):
        fn(args[0], args[1][:, :, :1], *args[2:])
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fn(*meta)
    with pytest.raises(ValueError, match="several devices"):
        fn(*args[:-1], meta[-1])
    if not decode:
        with pytest.raises(ValueError, match="window"):
            fn(*args, window=0)


@pytest.mark.parametrize("op", ["gcn_agg", "edge_score", "flash_attention",
                                "decode_attention"])
def test_ops_raise_on_requires_grad(op):
    """``decode_attention`` has no backward and raises on an input that
    requires grad; the actor kernels and ``flash_attention`` differentiate
    (tests/test_torch_train.py and tests/test_torch_train_lm.py hold the
    gradients) and build no graph under no_grad."""
    if op in ("flash_attention", "decode_attention"):
        _, args = attn_args(0, 1, 64, 4, 2, 32,
                            decode=op == "decode_attention")
    else:
        args = to_torch(gcn_args(0, 1, 4, 3) if op == "gcn_agg"
                        else edge_args(0, 1, 4, 3))
    args[1].requires_grad_(True)
    if op == "decode_attention":
        with pytest.raises(NotImplementedError, match="forward-only"):
            getattr(ops, op)(*args)
        return
    out = getattr(ops, op)(*args)
    assert out.requires_grad and out.grad_fn is not None
    with torch.no_grad():
        assert not getattr(ops, op)(*args).requires_grad


@pytest.mark.parametrize("op", ["gcn_agg", "edge_score"])
def test_wrappers_refuse_other_devices(op):
    args = gcn_args(0, 1, 4, 3) if op == "gcn_agg" else edge_args(0, 1, 4, 3)
    fn = gcn_mod.gcn_agg if op == "gcn_agg" else edge_mod.edge_score
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fn(*to_torch(args, "meta"))
    mixed = to_torch(args)[:-1] + to_torch(args[-1:], "meta")
    with pytest.raises(ValueError, match="several devices"):
        fn(*mixed)


# ------------------------------------------------------------- split-KV decode
def split_args(seed, b, h, kvh, d, s, lens):
    (jq, jk, jv, _), (q, k, v, _) = attn_args(seed, b, s, h, kvh, d,
                                              decode=True)
    lens = np.asarray(lens, np.int32)
    return (jq, jk, jv, jnp.asarray(lens)), (q, k, v, torch.tensor(lens))


@pytest.mark.parametrize("b,h,kvh,d,s,splits,lens", SPLIT_CASES)
def test_decode_split_ref_matches_pallas_and_jax_ref(b, h, kvh, d, s, splits,
                                                     lens):
    """The kernel's split-KV arithmetic in plain PyTorch against the TPU
    kernel (interpret) and both refs, f32 2e-5, wherever a sequence has a
    row; a sequence with none (length 0) attends uniformly over all its
    rows in all four, so each gives the mean of its V rows."""
    jx, tx = split_args(s + h + d + splits, b, h, kvh, d, s, lens)
    got = ref.decode_attention_split_ref(*tx, splits)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    has = np.asarray(lens) > 0
    g = h // kvh
    v_mean = np.repeat(as_f32(tx[2]).mean(1), g, axis=1)   # [B, H, d]
    for want in (jax_decode(*jx, block_k=128),
                 jax_ref.decode_attention_ref(*jx),
                 ref.decode_attention_ref(*tx)):
        want = as_f32(want)
        np.testing.assert_allclose(as_f32(got)[has], want[has],
                                   **ATTN_TOL["float32"])
        if not has.all():
            np.testing.assert_allclose(want[~has], v_mean[~has],
                                       **ATTN_TOL["float32"])
    np.testing.assert_allclose(as_f32(got)[~has], v_mean[~has],
                               **ATTN_TOL["float32"])


@pytest.mark.parametrize("splits", range(1, decode_mod.MAX_SPLITS + 1))
def test_decode_split_ref_agrees_at_every_split_count(splits):
    _, tx = split_args(11, 3, 8, 2, 64, 512, (512, 37, 300))
    np.testing.assert_allclose(
        ref.decode_attention_split_ref(*tx, splits).numpy(),
        ref.decode_attention_ref(*tx).numpy(), **ATTN_TOL["float32"])


def test_decode_split_ref_rounds_like_the_dtype():
    _, tx = split_args(12, 2, 4, 2, 32, 256, (200, 256))
    tx = [x.bfloat16() if x.is_floating_point() else x for x in tx]
    got = ref.decode_attention_split_ref(*tx, 4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(as_f32(got),
                               as_f32(ref.decode_attention_ref(*tx)),
                               **ATTN_TOL["bfloat16"])


@pytest.mark.parametrize("sms", [1, 16, 132, 144])
def test_decode_split_count(sms):
    """One split once B * KVH blocks give every SM two; otherwise at most
    the portable cluster size, and every split of a full cache holds a
    row; 8 at Llama-3.2-1B's B=1 against 4096 rows on 132 SMs."""
    for b in (1, 2, 8, 16, 33, 64, 300):
        for kvh in (1, 2, 8):
            for s in (1, 64, 255, 256, 300, 1000, 2048, 4096, 100000):
                n = decode_mod.n_splits(b, kvh, s, sms)
                assert 1 <= n <= decode_mod.MAX_SPLITS
                if b * kvh >= 2 * sms:
                    assert n == 1
                per = -(-s // n)
                assert (n - 1) * per < s, (b, kvh, s, n)   # no empty split
                assert n == 1 or per >= decode_mod.MIN_SPLIT_ROWS
                assert decode_mod.n_warps(b * kvh * n, sms) in (4, 8)
    assert decode_mod.n_splits(1, 8, 4096, 132) == 8
    assert decode_mod.n_splits(64, 8, 4096, 132) == 1
    assert decode_mod.n_splits(8, 8, 256, 132) == 1


# ------------------------------------------------- actor kernels' tiling
# (M, H) of the four gcn_agg launches of one actor forward
ACTOR_TILES = sorted({(m, h) for m, _, _, _, h in SLICE_GCN})
GRID_X, GRID_Y = 2 ** 31 - 1, 65535     # CUDA's grid limits


def covered_once(n, step, blocks):
    """Blocks of ``step`` items from 0 on cover 0..n-1, each exactly once,
    with no empty block."""
    counts = np.zeros(n, dtype=np.int64)
    for i in range(blocks):
        counts[i * step:min((i + 1) * step, n)] += 1
    return bool((counts == 1).all()) and (blocks - 1) * step < n


@pytest.mark.parametrize("m,h", ACTOR_TILES)
@pytest.mark.parametrize("sms", [16, 132, 144])
def test_gcn_tiling_covers_every_graph_and_column_once(m, h, sms):
    """For B in 1..1100: the tiles cover every row of [B*M, H] once and
    every column once (so every (graph, column) once), a tile holds whole
    graphs and whole rows of H, G = 1 while B <= the SM count, and the grid
    stays in CUDA's limits."""
    for b in range(1, 1101):
        t = gcn_mod.tiling(b, m, h, sms)
        assert t.rows == t.graphs * m and t.rows <= gcn_mod.MAX_ROWS
        assert t.cols % gcn_mod.TN == 0 and t.cols == min(h, gcn_mod.MAX_COLS)
        assert covered_once(b * m, t.rows, t.grid[0]), (b, t)
        assert covered_once(h, t.cols, t.grid[1]), (b, t)
        assert t.grid[0] <= GRID_X and t.grid[1] <= GRID_Y
        if b <= sms:
            assert t.graphs == 1
        else:
            # packed graphs keep about two blocks per SM, and no more
            assert t.grid[0] <= 2 * sms or t.graphs == gcn_mod.MAX_ROWS // m


def test_gcn_tiling_at_the_main_path():
    """On an H100's 132 SMs: B = 1 and 64 take one graph a block, whole
    rows; B = 1024 packs four graphs a block, 256 blocks."""
    assert gcn_mod.tiling(64, 14, 128, 132)[:3] == (1, 14, 128)
    assert gcn_mod.tiling(64, 14, 64, 132)[:3] == (1, 14, 64)
    assert gcn_mod.tiling(1, 10, 64, 132)[:3] == (1, 10, 64)
    t = gcn_mod.tiling(1024, 14, 64, 132)
    assert t[:3] == (4, 56, 64) and t.grid == (256, 1)
    assert gcn_mod.tiling(1000, 10, 128, 132).grid == (250, 1)
    assert gcn_mod.tiling(7, 5, 300, 132).grid == (7, 3)   # H > MAX_COLS


@pytest.mark.parametrize("b", [1, 64, 1000, 1024])
@pytest.mark.parametrize("m,o,fs,fn,h", SLICE_GCN)
def test_gcn_plan_fits_the_card_at_the_main_path(b, m, o, fs, fn, h):
    """The actor's launches take their tiling unchanged, within the
    block's threads and shared memory; K is split only at layer 2 (K =
    256), and only where a tile has few micro-tiles."""
    t, ks, st = gcn_mod.plan(b, m, o, fs, fn, h, 132)
    assert t == gcn_mod.tiling(b, m, h, 132)
    n = gcn_mod.threads(t.rows, t.cols, ks)
    assert 1 <= n <= gcn_mod.MAX_THREADS
    assert gcn_mod.smem_bytes(m, o, fs, fn, t.rows, t.cols, ks, st) \
        <= gcn_mod.SMEM_TWO_PER_SM       # two blocks fit an SM
    assert ks == 1 if fs + fn < 2 * gcn_mod.KT or b > 132 else ks > 1
    # every K-tile in flight at once where there is room: layer 1 is one
    # tile; layer 2's eight at one graph a block, three or four at four
    if fs + fn < gcn_mod.KT:
        assert st == 1
    else:
        assert st == 8 if b <= 132 else 3 <= st < 8


def test_gcn_plan_takes_every_shape_the_first_design_took():
    """The first design (one block per graph) took every shape whose
    M*O + M*Fs + O*Fn + M*Fn + M floats fit 48 KB; the tiled kernel fits
    each such shape within a block's threads and shared memory, at any B,
    graphs larger than a tile included."""
    rng = np.random.default_rng(0)
    tried = 0
    while tried < 3000:
        m, o, fs, fn = (int(x) for x in rng.integers(1, 200, size=4))
        fs, fn = int(rng.choice([fs, fs * 30])), int(rng.choice([fn, fn * 30]))
        if m * o + m * fs + o * fn + m * fn + m > 12288:
            continue
        tried += 1
        h = int(rng.integers(1, 600))
        b = int(rng.choice([1, 7, 64, 200, 1024, 5000]))
        t, ks, st = gcn_mod.plan(b, m, o, fs, fn, h, 132)
        assert gcn_mod.smem_bytes(m, o, fs, fn, t.rows, t.cols, ks, st) \
            <= gcn_mod.SMEM_LIMIT, (b, m, o, fs, fn, h, t, ks, st)
        assert 1 <= st <= gcn_mod.MAX_STAGES
        assert 1 <= gcn_mod.threads(t.rows, t.cols, ks) <= gcn_mod.MAX_THREADS
        assert covered_once(b * m, t.rows, t.grid[0])
        assert covered_once(h, t.cols, t.grid[1])


@pytest.mark.parametrize("k", [1, 11, 14, 63, 64, 256, 1000])
def test_gcn_k_split(k):
    """1 below two K-tiles; else a power of two up to MAX_SPLIT that keeps
    the block within SPLIT_THREADS threads (or 1 if one slice exceeds it)."""
    for rows in (1, 5, 10, 14, 28, 56, 64):
        for cols in (4, 16, 32, 64, 128):
            ks = gcn_mod.k_split(rows, cols, k)
            n = gcn_mod.threads(rows, cols, ks)
            assert ks in (1, 2, 4, 8)
            if k < 2 * gcn_mod.KT:
                assert ks == 1
            elif ks > 1:
                assert n <= gcn_mod.SPLIT_THREADS
            if ks < gcn_mod.MAX_SPLIT and k >= 2 * gcn_mod.KT:
                assert 2 * n > gcn_mod.SPLIT_THREADS


@pytest.mark.parametrize("sms", [16, 132])
def test_edge_score_graphs_per_block(sms):
    """One graph a block while B <= the SM count; else packed so that the
    blocks are about two per SM, at most MAX_ROWS rows of either side, in
    shared memory that lets two blocks share an SM at the actor's
    widths."""
    for b in range(1, 1101):
        g = edge_mod.graphs(b, 14, 10, 64, 64, sms)
        if b <= sms:
            assert g == 1
        assert 1 <= g and g * 14 <= gcn_mod.MAX_ROWS
        assert -(-b // g) <= 2 * sms or g == gcn_mod.MAX_ROWS // 14
        assert edge_mod.smem_bytes(14, 10, 64, 64, g) <= gcn_mod.SMEM_TWO_PER_SM
    assert edge_mod.graphs(1024, 14, 10, 64, 64, 132) == 4
    # a width whose packed block would not fit is packed less
    assert edge_mod.graphs(1024, 14, 10, 512, 256, 132) == 1


def test_decode_wrapper_forced_splits_on_cpu():
    """A forced split count is range-checked; a CPU tensor runs the plain
    version whatever the count."""
    _, tx = split_args(13, 2, 4, 2, 32, 256, (0, 200))
    for splits in (None, 1, 3, decode_mod.MAX_SPLITS):
        assert torch.equal(decode_mod.decode_attention(*tx, splits=splits),
                           ref.decode_attention_ref(*tx))
    for bad in (0, decode_mod.MAX_SPLITS + 1):
        with pytest.raises(ValueError, match="splits"):
            decode_mod.decode_attention(*tx, splits=bad)


# ------------------------------------------------- bf16 flash kernel's rounding
@pytest.mark.parametrize("b,s,h,kvh,d,win", FLASH_GRID + [
    (1, 200, 4, 2, 64, None), (1, 200, 8, 2, 128, 64)])
def test_flash_bf16_kernel_rounding_within_the_bf16_gate(b, s, h, kvh, d,
                                                         win):
    """P rounded to bf16 before P V (the tensor-core kernel's one extra
    rounding), and the output rounded to bf16 as the kernel stores it,
    keep the output within the bf16 gate of JAX's kernel (interpret) and
    of the plain version."""
    (jq, jk, jv), (q, k, v) = attn_args(s + h + d + 1, b, s, h, kvh, d,
                                        "bfloat16")
    got = ref.flash_attention_bf16_emulation(q, k, v, window=win).bfloat16()
    wants = [ref.flash_attention_ref(q, k, v, window=win)]
    if s % 64 == 0:     # the TPU kernel takes whole blocks only
        wants.append(jax_flash(jq, jk, jv, window=win, block_q=64,
                               block_k=64))
    for want in wants:
        np.testing.assert_allclose(as_f32(got), as_f32(want),
                                   **ATTN_TOL["bfloat16"])

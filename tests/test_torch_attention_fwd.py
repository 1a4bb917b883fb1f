"""The host side and the arithmetic of the port's Hopper attention forwards
(``csrc/attention_bnhd.cu``: ``attn_fwd_kernel`` for B2, B8 at head dims up
to 128 and B17-B19; ``attn_wide_kernel`` for B8 at the GPT prior's 384),
on the CPU.

The kernel addresses q, k, v and its output through 4-D TMA tensor maps
over (lanes, heads, rows, batches), one stride per axis.
``ops.attention.attention_fwd_maps`` mirrors the maps its host plan
encodes; for every layout the entry points accept, the element a map
addresses must be the one ``torch.as_strided`` gives, every stride a
nonzero multiple of 16 bytes and every box within the TMA's limits, and
the mirror must refuse what the C entry refuses.

A head dim that is a multiple of 8 up to 128 runs on the next of the
kernel's tiles of 32, 64 and 128 lanes: the maps' lane extent stays the
head dim, so the boxes load zeros past it and the stores drop those lanes.
``ops.attention.attention_route`` names the kernel and tile each dtype and
head dim takes, as the C entries choose them.

The kernels walk the keys in tiles of 128 (64 at D = 384) and round P to
bf16 against the running row max. That recurrence is written out here and
held to the plain version and to the JAX packed kernel (128- or 64-key
chunks, interpret mode), and at D = 80 on inputs zero-padded to the 128
tile to the JAX ``multihead_attention_bnhd``, which pads D = 80 itself.
Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from enhancing_tpu.ops import attention as jatt
from enhancing_tpu_torch.ops import attention as tatt

KEYS = 128  # keys a tile of attn_fwd_kernel
WIDE_KEYS = 64  # keys a tile of attn_wide_kernel (D = 384)
# the TMA's limits (cuTensorMapEncodeTiled): a box edge of at most 256
# elements, an inner box edge of at most the swizzle span (128 bytes),
# global dims up to 2^32 and strides below 2^40
BOX_EDGE, SWIZZLE_BYTES = 256, 128


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ENHANCING_TPU_PALLAS_INTERPRET", "1")


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)


# -- the tensor maps -----------------------------------------------------------

def _check_map(base, offset, dims, strides, box, view, rng):
    """The map's element at random coordinates against the view's, and the
    map's strides and box against the TMA's limits."""
    assert all(s > 0 and s % 16 == 0 and s < 2 ** 40 for s in strides)
    assert all(0 < d <= 2 ** 32 for d in dims)
    assert all(0 < e <= BOX_EDGE for e in box)
    assert box[0] * 2 <= SWIZZLE_BYTES and box[0] * 2 in (64, 128)
    assert box[1] == box[3] == 1 and offset % 16 == 0
    # the kernel's boxes cover its tile, which holds the head dim's lanes
    tile = tatt.attention_route(torch.bfloat16, dims[0])[1]
    assert tile % box[0] == 0 and dims[0] <= tile
    flat = base.reshape(-1)
    want_view = torch.as_strided(base, view.shape, view.stride(),
                                 view.storage_offset())
    b, n, h, d = view.shape
    assert dims == (d, h, n, b)
    for _ in range(64):
        lane, head, row, batch = (int(rng.integers(0, e)) for e in dims)
        byte = (offset + 2 * lane + head * strides[0] + row * strides[1]
                + batch * strides[2])
        assert byte % 2 == 0
        got = flat[byte // 2]
        assert got.view(torch.int16) == want_view[batch, row, head,
                                                  lane].view(torch.int16)


def _strided_maps(q, k, v, o):
    b, n, h, d = q.shape
    strides = tatt.strided_launch_args("test", (q, k, v, o))
    return tatt.attention_fwd_maps(b, n, k.shape[1], h, d, strides)


def _offset(view, base):
    return (view.data_ptr() - base.data_ptr())


# (B, N, M, H, D) shapes, N = 1, size-1 batch and head axes included; at
# D = 384 the int8 prefill's contiguous q, k, v (B8, N = 1) and M != N;
# head dims between the tiles (16, 48, 80, 96)
SHAPES = [(2, 100, 100, 3, 64), (1, 1, 1, 1, 32), (3, 1, 65, 4, 128),
          (1, 65, 130, 1, 64), (2, 64, 63, 2, 32), (8, 1, 1, 16, 384),
          (2, 70, 130, 2, 384), (2, 33, 33, 3, 16), (1, 65, 70, 2, 48),
          (2, 100, 100, 16, 80), (1, 1, 9, 1, 96)]


@pytest.mark.parametrize("b,n,m,h,d", SHAPES)
def test_maps_of_bnhd_tensors(b, n, m, h, d):
    """(B, N, H, D) q and out, (B, M, H, D) k and v, contiguous (B8, B18)."""
    rng = np.random.default_rng(b * 1000 + n + m + h + d)
    q, o = _bf16(rng, (b, n, h, d)), _bf16(rng, (b, n, h, d))
    k, v = _bf16(rng, (b, m, h, d)), _bf16(rng, (b, m, h, d))
    for t, mp in zip((q, k, v, o), _strided_maps(q, k, v, o)):
        _check_map(t, *mp, t, rng)


@pytest.mark.parametrize("b,n,m,h,d", SHAPES)
def test_maps_of_bhnd_tensors(b, n, m, h, d):
    """(B, H, N, D) tensors (B17), which the wrapper views as (B, N, H, D):
    a head stride above the row stride."""
    rng = np.random.default_rng(b * 1000 + n + m + h + d + 1)
    qt, ot = _bf16(rng, (b, h, n, d)), _bf16(rng, (b, h, n, d))
    kt, vt = _bf16(rng, (b, h, m, d)), _bf16(rng, (b, h, m, d))
    views = [t.transpose(1, 2) for t in (qt, kt, vt, ot)]
    for base, view, mp in zip((qt, kt, vt, ot), views, _strided_maps(*views)):
        _check_map(base, *mp, view, rng)


@pytest.mark.parametrize("b,n,h,d", [(2, 77, 3, 64), (1, 1, 2, 32),
                                     (3, 65, 1, 128), (1, 130, 4, 64),
                                     (2, 65, 16, 80), (1, 9, 2, 48)])
def test_maps_of_the_packed_qkv_buffer(b, n, h, d):
    """B2: q, k and v as lane slices of one (B, N, 3*H*D) buffer, as
    etk_attention_qkv plans them, and as the strided entry sees the same
    slices (B8 on them must give B2's output bit for bit, so the maps must
    match)."""
    rng = np.random.default_rng(n + h + d)
    qkv = _bf16(rng, (b, n, 3 * h * d))
    out = _bf16(rng, (b, n, h * d))
    strides, offsets = tatt.packed_qkv_strides(b, n, h, d)
    packed = tatt.attention_fwd_maps(b, n, n, h, d, strides, offsets)
    slices = [t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1)]
    views = slices + [out.view(b, n, h, d)]
    for base, view, mp in zip((qkv, qkv, qkv, out), views, packed):
        _check_map(base, *mp, view, rng)
    strided = _strided_maps(*views)
    for mp, sp, view, base in zip(packed, strided, views,
                                  (qkv, qkv, qkv, out)):
        assert mp[0] == _offset(view, base) and sp[0] == 0
        assert mp[1:] == sp[1:]


@pytest.mark.parametrize("b,n", [(2, 1025), (8, 1)])
def test_maps_of_the_prior_qkv_lane_slices(b, n):
    """B8 at D = 384: q, k and v as the lane slices of the prior's (B, N,
    3 * 6144) qkv buffer (16 heads of 384), at the teacher-forced forward's
    N = 1025 and the prefill's N = 1, out contiguous (B, N, 16, 384)."""
    h, d = 16, 384
    rng = np.random.default_rng(b + n)
    qkv = torch.from_numpy(rng.integers(-30000, 30000, (b, n, 3 * h * d),
                                        dtype=np.int16)).view(torch.bfloat16)
    out = torch.zeros(b, n, h, d, dtype=torch.bfloat16)
    views = [t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1)] + [out]
    for base, view, mp in zip((qkv, qkv, qkv, out), views,
                              _strided_maps(*views)):
        _check_map(base, mp[0] + _offset(view, base), *mp[1:], view, rng)


@pytest.mark.parametrize("b,n,h,d", [(2, 1025, 16, 64), (1, 3, 2, 128),
                                     (4, 1, 8, 32)])
def test_maps_of_the_gridchunk_operands(b, n, h, d):
    """B19: packed (B, N, H*D) q, k, v, unflattened to (B, N, H, D)."""
    rng = np.random.default_rng(b + n + h + d)
    q3, k3, v3, o3 = (_bf16(rng, (b, n, h * d)) for _ in range(4))
    views = [t.unflatten(-1, (h, d)) for t in (q3, k3, v3, o3)]
    for base, view, mp in zip((q3, k3, v3, o3), views, _strided_maps(*views)):
        _check_map(base, *mp, view, rng)


def test_extent_one_axes_take_a_legal_stride():
    """strided_launch_args gives 0 for an axis of size 1; the map replaces
    it by D elements, since the TMA wants every stride nonzero."""
    q = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16)
    strides = tatt.strided_launch_args("test", (q,) * 4)
    assert strides == [0] * 12
    for mp in tatt.attention_fwd_maps(1, 1, 1, 1, 64, strides):
        assert mp[2] == (128, 128, 128)


@pytest.mark.parametrize("d", [20, 100, 136, 192, 256])
def test_mirror_refuses_head_dims_the_kernel_does_not_take(d):
    """Not a multiple of 8, or above 128 but not the prior's 384."""
    with pytest.raises(ValueError, match="head_dim"):
        tatt.attention_fwd_maps(1, 8, 8, 2, d, [0] * 12)


@pytest.mark.parametrize("d,tile", [(8, 32), (16, 32), (32, 32), (48, 64),
                                    (64, 64), (80, 128), (96, 128),
                                    (128, 128), (384, 384)])
def test_mirror_takes_head_dims_between_the_tiles(d, tile):
    """A multiple of 8 up to 128 runs on the next tile; the maps keep the
    head dim as their lane extent, with the tile's boxes (32 lanes on the
    32 tile, else 64)."""
    assert tatt.attention_route(torch.bfloat16, d)[1] == tile
    maps = tatt.attention_fwd_maps(1, 8, 8, 1, d, [0, 0, d] * 4)
    for _, dims, _, box in maps:
        assert dims[0] == d and box[0] == (32 if tile == 32 else 64)


# (dtype, head dim, backward) -> (kernel, tile), as the C entries choose
ROUTES = [
    (torch.bfloat16, 16, False, ("attn_fwd_kernel", 32)),
    (torch.bfloat16, 64, False, ("attn_fwd_kernel", 64)),
    (torch.bfloat16, 80, False, ("attn_fwd_kernel", 128)),
    (torch.bfloat16, 384, False, ("attn_wide_kernel", 384)),
    (torch.bfloat16, 48, True, ("attn_bwd", 64)),
    (torch.bfloat16, 80, True, ("attn_bwd", 128)),
    (torch.float32, 64, False, ("attn_f32_fwd_kernel", 64)),
    (torch.float32, 80, False, ("attn_f32_fwd_kernel", 128)),
    (torch.float32, 120, False, ("attn_f32_fwd_kernel", 128)),
    (torch.float32, 384, False, ("attn_f32_wide_kernel", 384)),
    (torch.float32, 80, True, ("attn_f32_bwd", 128)),
    (torch.float32, 32, True, ("attn_f32_bwd", 32)),
    (torch.bfloat16, 384, True, ("attn_bwd_wide", 384)),
    (torch.float32, 384, True, ("attn_f32_bwd_wide", 384)),
]


@pytest.mark.parametrize("dtype,d,backward,want", ROUTES)
def test_attention_route_by_dtype_and_head_dim(dtype, d, backward, want):
    assert tatt.attention_route(dtype, d, backward) == want


@pytest.mark.parametrize("dtype,d,backward,err", [
    (torch.float16, 64, False, TypeError),
    (torch.int8, 64, True, TypeError),
    (torch.bfloat16, 20, False, ValueError),
    (torch.bfloat16, 192, False, ValueError),
    (torch.float32, 256, False, ValueError),
    (torch.bfloat16, 192, True, ValueError),
    (torch.float32, 4, True, ValueError)])
def test_attention_route_refusals(dtype, d, backward, err):
    """fp16, int8, head dims not a multiple of 8 or above 128 but not 384
    (192 among them, forward and backward: ROADMAP.md queue B)."""
    with pytest.raises(err):
        tatt.attention_route(dtype, d, backward)


@pytest.mark.parametrize("which,stride", [(0, 12), (1, 4), (2, -8),
                                          (5, 2 ** 31), (11, 3)])
def test_mirror_refuses_strides_the_kernel_does_not_take(which, stride):
    """Strides that are no multiple of 8 elements (16 bytes), negative or
    past an int, in any of the twelve."""
    strides = [100 * 8, 8, 64] * 4
    strides[which] = stride
    with pytest.raises(ValueError, match="stride"):
        tatt.attention_fwd_maps(2, 8, 8, 2, 64, strides)


def test_mirror_refuses_a_zero_stride_on_a_real_axis():
    """A broadcast axis (stride 0, extent above 1) cannot be a TMA map's."""
    strides = [512, 0, 128] * 4  # heads at stride 0, H = 2
    with pytest.raises(ValueError, match="stride"):
        tatt.attention_fwd_maps(2, 8, 8, 2, 64, strides)
    q = torch.zeros(2, 8, 1, 64, dtype=torch.bfloat16).expand(2, 8, 2, 64)
    with pytest.raises(ValueError, match="stride"):
        tatt.attention_strided_kernel("attention_bnhd", q, q, q, 0.1)


@pytest.mark.parametrize("b,h", [(0, 2), (2, 0), (65536, 1), (1, 65536)])
def test_mirror_refuses_grids_the_kernel_does_not_take(b, h):
    with pytest.raises(ValueError, match="grid"):
        tatt.attention_fwd_maps(b, 8, 8, h, 64, [0] * 12)


def test_strided_entry_refuses_before_any_launch():
    """The wrapper runs the mirror before the C call: a CPU tensor with a
    head dim of 192 or strides off by 8 elements raises ValueError, never a
    build or launch."""
    with pytest.raises(ValueError):
        tatt.attention_bnhd_kernel(*(torch.zeros(1, 8, 2, 192,
                                                 dtype=torch.bfloat16),) * 3,
                                   0.1)
    # lane slices of rows 132 elements apart
    base = torch.zeros(1, 8, 2 * 64 + 4, dtype=torch.bfloat16)
    q = base[..., :128].unflatten(-1, (2, 64))
    with pytest.raises(ValueError):
        tatt.attention_bnhd_kernel(q, q, q, 0.1)


# -- the tile recurrence -------------------------------------------------------

def tile_recurrence(q, k, v, mask_mode, cond_len, keys=KEYS):
    """attn_fwd_kernel's arithmetic on (B, H, N, D) q (already scaled) and
    (B, H, M, D) k, v: fp32 scores, keys in tiles of ``keys`` with the
    running row max m, l and O rescaled by exp(m_old - m) whenever m moves,
    P = exp(s - m) cast to v's dtype before P V (l sums the fp32 values),
    one 1 / l at the end and one rounding to q's dtype. A row with nothing
    visible yet takes m = 0 for its exponentials."""
    n, m = q.shape[-2], k.shape[-2]
    s = q.float() @ k.float().transpose(-1, -2)
    if mask_mode == "prefix_causal":
        rows = torch.arange(n)[:, None]
        cols = torch.arange(m)[None, :]
        allowed = (cols <= rows) | ((rows < cond_len) & (cols < cond_len))
        s = torch.where(allowed, s, -torch.inf)
    run = torch.full(s.shape[:-1], -torch.inf)
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(*s.shape[:-1], v.shape[-1])
    for t0 in range(0, m, keys):
        st = s[..., t0:t0 + keys]
        m_new = torch.maximum(run, st.amax(-1))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp(run - m_use)
        p = torch.exp(st - m_use[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.to(v.dtype).float() @ v[
            ..., t0:t0 + keys, :].float()
        run = m_new
    return (o * (1.0 / l)[..., None]).to(q.dtype)


def _attention_inputs(rng, n, d=64):
    b, h = 2, 2
    q, k, v = (rng.standard_normal((b, n, h * d)).astype(np.float32)
               for _ in range(3))
    q = q * np.float32(d ** -0.5)
    return b, h, d, q, k, v


def _heads(a, h, d, dtype):
    b, n, _ = a.shape
    return torch.from_numpy(a).to(dtype).reshape(b, n, h, d).transpose(1, 2)


def _jax_chunked(q3, k3, v3, mode, cl, d, dtype, keys=KEYS):
    """The JAX packed kernel with the online softmax over ``keys``-key
    chunks (padding keys masked), P cast to v's dtype against the running
    max: the recurrence above, run in interpret mode."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out = jatt._attention_packed_call(
        *(jnp.asarray(a).astype(jdt) for a in (q3, k3, v3)), mode, cl, d,
        k_chunk=keys)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 3)])
@pytest.mark.parametrize("n", [63, 64, 65, 130])
def test_tile_recurrence_f32_matches_plain_and_jax(interpret, mode, cl, n):
    """In fp32 (P's cast a no-op) the recurrence is the softmax of the
    whole row: held to the plain version and to the JAX kernel at
    tests/test_torch_ops.py's attention tolerance (a few fp32 ulps of
    O(1) values in another summation order)."""
    b, h, d, q3, k3, v3 = _attention_inputs(np.random.default_rng(n), n)
    q, k, v = (_heads(a, h, d, torch.float32) for a in (q3, k3, v3))
    got = tile_recurrence(q, k, v, mode, cl)
    got3 = got.transpose(1, 2).reshape(b, n, h * d).numpy()
    want = tatt.attention_plain(q, k, v, 1.0, mode, cl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got3, _jax_chunked(q3, k3, v3, mode, cl, d,
                                                  torch.float32),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 3)])
@pytest.mark.parametrize("n", [63, 64, 65, 130])
def test_tile_recurrence_bf16_matches_plain_and_jax(interpret, mode, cl, n):
    """In bf16, against the JAX kernel that rounds at the same places: the
    two exponentials differ by an fp32 ulp, which may flip P's bf16
    rounding of a term (moving an output by 2^-8 of that term, held to
    2^-8 of the largest |output|), and the output's own rounding may then
    differ by one bf16 step (rtol 2^-7). Against the plain version, which
    rounds the normalised P instead: a bf16 step of every P, held to 2^-7
    of the largest |plain| + 2^-7 relative. Both under the bf16 limits of
    tests/test_torch_ops.py's backward test (2^-6 and 2^-6)."""
    b, h, d, q3, k3, v3 = _attention_inputs(np.random.default_rng(n + 1),
                                            n)
    q3, k3, v3 = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                  for a in (q3, k3, v3))
    q, k, v = (_heads(a, h, d, torch.bfloat16) for a in (q3, k3, v3))
    got = tile_recurrence(q, k, v, mode, cl).float()
    got3 = got.transpose(1, 2).reshape(b, n, h * d).numpy()
    want = _jax_chunked(q3, k3, v3, mode, cl, d, torch.bfloat16)
    np.testing.assert_allclose(got3, want, atol=2.0 ** -8 * np.abs(
        want).max(), rtol=2.0 ** -7)
    plain = tatt.attention_plain(q, k, v, 1.0, mode, cl).float()
    scale = float(plain.abs().max())
    np.testing.assert_allclose(got.numpy(), plain.numpy(),
                               atol=2.0 ** -7 * scale, rtol=2.0 ** -7)


@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 3)])
@pytest.mark.parametrize("n", [63, 64, 65, 130])
def test_wide_tile_recurrence_f32_matches_plain_and_jax(interpret, mode, cl,
                                                        n):
    """attn_wide_kernel's recurrence at the prior's D = 384, 64-key tiles,
    2 heads: in fp32 the softmax of the whole row, held to the plain
    version and to the JAX kernel with 64-key chunks at the limits of the
    128-key test above."""
    b, h, d, q3, k3, v3 = _attention_inputs(np.random.default_rng(n + 2), n,
                                            384)
    q, k, v = (_heads(a, h, d, torch.float32) for a in (q3, k3, v3))
    got = tile_recurrence(q, k, v, mode, cl, WIDE_KEYS)
    got3 = got.transpose(1, 2).reshape(b, n, h * d).numpy()
    want = tatt.attention_plain(q, k, v, 1.0, mode, cl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got3, _jax_chunked(q3, k3, v3, mode, cl, d,
                                                  torch.float32, WIDE_KEYS),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 3)])
@pytest.mark.parametrize("n", [63, 64, 65, 130])
def test_wide_tile_recurrence_bf16_matches_plain_and_jax(interpret, mode, cl,
                                                         n):
    """The same in bf16, P rounded against a running max that moves every
    64 keys: against the JAX kernel with 64-key chunks, 2^-8 of the largest
    |output| + 2^-7 relative; against the plain version (which rounds the
    normalised P), 2^-7 of the largest |plain| + 2^-7 relative; the reasons
    of the 128-key bf16 test above."""
    b, h, d, q3, k3, v3 = _attention_inputs(np.random.default_rng(n + 3), n,
                                            384)
    q3, k3, v3 = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                  for a in (q3, k3, v3))
    q, k, v = (_heads(a, h, d, torch.bfloat16) for a in (q3, k3, v3))
    got = tile_recurrence(q, k, v, mode, cl, WIDE_KEYS).float()
    got3 = got.transpose(1, 2).reshape(b, n, h * d).numpy()
    want = _jax_chunked(q3, k3, v3, mode, cl, d, torch.bfloat16, WIDE_KEYS)
    np.testing.assert_allclose(got3, want, atol=2.0 ** -8 * np.abs(
        want).max(), rtol=2.0 ** -7)
    plain = tatt.attention_plain(q, k, v, 1.0, mode, cl).float()
    scale = float(plain.abs().max())
    np.testing.assert_allclose(got.numpy(), plain.numpy(),
                               atol=2.0 ** -7 * scale, rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 3)])
def test_head_dim_80_on_the_128_tile(interpret, dtype, mode, cl):
    """A head dim of 80 (a 1280-wide tower over 16 heads) as
    attn_fwd_kernel runs it on its 128-lane tile: q, k and v zero-padded to
    128 lanes (the TMA's fill), the 128-key recurrence, the lanes past 80
    dropped (the store's clip). The zero lanes add nothing: held to the
    unpadded plain version and to the JAX ``multihead_attention_bnhd``,
    which pads D = 80 to 128 itself and runs its packed kernel (interpret
    mode), at the limits of the recurrence tests above (in bf16 against
    JAX's whole-row softmax, the plain version's limits)."""
    b, n, h, d = 2, 130, 2, 80
    rng = np.random.default_rng(80)
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32)
               for _ in range(3))
    if dtype == torch.bfloat16:
        q, k, v = (torch.from_numpy(a).to(dtype).float().numpy()
                   for a in (q, k, v))
    scale = d ** -0.5
    qt, kt, vt = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    qs = qt * torch.tensor(scale, dtype=dtype)  # q scaled in its dtype
    pad = [torch.nn.functional.pad(t, (0, 128 - d)).transpose(1, 2)
           for t in (qs, kt, vt)]
    got = tile_recurrence(*pad, mode, cl)[..., :d].transpose(1, 2).float()
    plain = tatt.attention_bnhd_plain(qt, kt, vt, scale, mode, cl).float()
    want = np.asarray(jatt.multihead_attention_bnhd(
        *(jnp.asarray(a).astype(jnp.float32 if dtype == torch.float32
                                else jnp.bfloat16) for a in (q, k, v)),
        scale=scale, mask_mode=mode, cond_len=cl,
        impl="pallas").astype(jnp.float32))
    if dtype == torch.float32:
        lim = dict(atol=3e-5, rtol=1e-4)
    else:
        lim = dict(atol=2.0 ** -7 * float(plain.abs().max()), rtol=2.0 ** -7)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **lim)
    np.testing.assert_allclose(got.numpy(), want, **lim)

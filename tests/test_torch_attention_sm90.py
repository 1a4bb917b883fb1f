"""The arithmetic of the port's Hopper attention kernels, on the CPU.

``csrc/attention_bwd.cu`` (B5) takes the row max m, the row sum l and
delta = rowsum(P * dP) from one online sweep over 64-key tiles, rescaling
l and sum(e * dP) whenever m moves. The recurrence is written out here in
fp32 and held to the delta that the plain attention implies (rowsum(P *
dP) over the whole row, and rowsum(dO * O)) and, through the dq it gives,
to the JAX backward kernel run in interpret mode. ``csrc/attn_proj.cu`` (B15) is planned on the host;
``ops.attention.attn_proj_plan`` mirrors that plan and must take every
stage-1 configuration the repository ships and refuse what the kernel
refuses. Inputs are made with numpy from a seed.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from enhancing_tpu.ops import attention as jatt
from enhancing_tpu_torch.ops import attention as tatt

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
TILE = 64  # keys a tile of the rows kernel


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ENHANCING_TPU_PALLAS_INTERPRET", "1")


def _inputs(rng, b, n, h, d):
    qkv = (rng.standard_normal((b, n, 3 * h * d)) * 0.5).astype(np.float32)
    do = rng.standard_normal((b, n, h * d)).astype(np.float32)
    q3, k3, v3 = (qkv[..., i * h * d:(i + 1) * h * d] for i in range(3))
    return q3 * d ** -0.5, k3, v3, do


def _heads(a, h, d):
    b, n, _ = a.shape
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(
        b, n, h, d).transpose(1, 2)


def _visible(n, mode, cl):
    rows = torch.arange(n)[:, None]
    cols = torch.arange(n)[None, :]
    if mode == "none":
        return torch.ones(n, n, dtype=torch.bool)
    return (cols <= rows) | ((rows < cl) & (cols < cl))


def one_sweep_stats(s, dp):
    """m, 1 / l and delta of each row of fp32 scores s (masked entries
    -inf) and dP, in one pass over TILE-key tiles: the rows kernel's
    sweep 1."""
    shape = s.shape[:-1]
    m = torch.full(shape, -torch.inf)
    l = torch.zeros(shape)
    g = torch.zeros(shape)
    for t0 in range(0, s.shape[-1], TILE):
        st, dpt = s[..., t0:t0 + TILE], dp[..., t0:t0 + TILE]
        m_new = torch.maximum(m, st.amax(-1))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp(m - m_use)
        e = torch.exp(st - m_use[..., None])
        l = l * alpha + e.sum(-1)
        g = g * alpha + (e * dpt).sum(-1)
        m = m_new
    inv = 1.0 / l
    return m, inv, g * inv


@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 5)])
@pytest.mark.parametrize("n", [1, 63, 64, 130])
def test_one_sweep_statistics_match_plain_and_jax(interpret, mode, cl, n):
    b, h, d = 2, 2, 64
    q3, k3, v3, do = _inputs(np.random.default_rng(n), b, n, h, d)
    q, k, v, dot = (_heads(a, h, d) for a in (q3, k3, v3, do))
    s = q @ k.transpose(-1, -2)
    s = torch.where(_visible(n, mode, cl), s, -torch.inf)
    dp = dot @ v.transpose(-1, -2)
    m, inv, delta = one_sweep_stats(s, dp)

    # the delta the plain backward implies: rowsum(P * dP) with P the
    # softmax of the whole row, as autograd of attention_plain forms it
    want = (torch.softmax(s, -1) * dp).sum(-1)
    np.testing.assert_allclose(delta.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    # and the output it belongs to: rowsum(dO * O) is the same sum by
    # another route, with fp32 cancellation of its own (1e-5 absolute)
    out = tatt.attention_plain(q, k, v, 1.0, mode, cl)
    np.testing.assert_allclose(delta.numpy(), (dot * out).sum(-1).numpy(),
                               rtol=1e-5, atol=1e-5)

    # the dq those statistics give, against the JAX backward kernel's
    p = torch.exp(s - m[..., None]) * inv[..., None]
    dq = (p * (dp - delta[..., None])) @ k
    ref = jatt._attention_packed_bwd_call(
        *(jnp.asarray(a) for a in (q3, k3, v3, do)), mode, cl, d)[0]
    got = dq.transpose(1, 2).reshape(b, n, h * d).numpy()
    ref = np.asarray(ref)
    # dq sums n products of (dP - delta), which cancel to near 0 in some
    # elements: their error is a few ulps of the largest term, so the
    # absolute part is 1e-6 of the largest |dq|
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def _stage1_attentions():
    """(config, heads, H*D, HO) of every attention in the shipped stage-1
    configs: each tower's heads of 64 and its width."""
    found = []
    for path in sorted(CONFIGS.glob("*vitvq_*.yaml")):
        params = yaml.safe_load(path.read_text())["model"]["params"]
        for tower in ("encoder", "decoder"):
            if tower not in params:
                continue
            t = params[tower]
            head_dim = t.get("dim_head", 64)
            found.append((path.stem, t["heads"], head_dim, t["dim"]))
    return found


def test_attn_proj_plan_takes_every_shipped_stage1_config():
    cases = _stage1_attentions()
    names = {c[0] for c in cases}
    assert {"imagenet_vitvq_small", "imagenet_vitvq_base",
            "imagenet_vitvq_large", "fake_vitvq_tiny",
            "fake_vitvq_base"} <= names
    for name, heads, head_dim, ho in cases:
        plan = tatt.attn_proj_plan(heads, head_dim, ho)
        assert plan is not None, (name, heads, head_dim, ho)
        assert 2 <= plan["stages"] <= 4
        assert plan["smem"] <= tatt.SMEM_LIMIT


@pytest.mark.parametrize("heads,head_dim,ho", [
    (12, 32, 768),   # head dim 32: not built
    (12, 128, 768),  # head dim 128: not built
    (12, 64, 800),   # HO not a multiple of 64
    (17, 64, 768),   # H*D = 1088: fewer than two ring stages fit
])
def test_attn_proj_plan_refuses_what_the_kernel_refuses(heads, head_dim, ho):
    assert tatt.attn_proj_plan(heads, head_dim, ho) is None
    q = torch.zeros(1, 4, heads, head_dim, dtype=torch.bfloat16)
    wp = torch.zeros(ho, heads * head_dim, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="attn_proj kernel takes"):
        tatt.attn_proj_kernel(q, q, q, wp, torch.zeros(ho),
                              torch.zeros(1, 4, ho, dtype=torch.bfloat16),
                              head_dim ** -0.5)


def test_attn_proj_plan_widest_accepted():
    """H*D = 1024 (imagenet_vitvq_large's decoder) leaves room for two 16
    KiB stages per warpgroup beside the output and q tiles; 1088 does
    not."""
    assert tatt.attn_proj_plan(16, 64, 1280)["stages"] == 2
    assert tatt.attn_proj_plan(12, 64, 768)["stages"] == 3
    assert tatt.attn_proj_plan(8, 64, 512)["stages"] == 4

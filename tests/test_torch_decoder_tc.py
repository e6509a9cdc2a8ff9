"""K2's tensor-core weight image and arithmetic against the JAX package, on
the CPU.

The CUDA kernel (``csrc/decoder_mlp.cu``) runs only on the card. These tests
pin what it reads and how it computes:

(a) the TF32 split of the weight image: every hi value has its low 13
    mantissa bits zero, hi + lo is within 2^-21 relative of the weight, and
    the K padding (93 -> 96) is exactly zero in hi and lo;
(b) an emulation of the kernel's arithmetic on the packed image (the fused
    e product, N = 64; the fused fc product, N = 160; the 32 x 32 chain; the
    head), written here from the kernel's register-fragment mapping, with
    every product as three TF32 products (rounding emulated on the float32
    bit pattern), against JAX ``fused_mlp_forward`` in Pallas interpret
    mode: rtol 1e-4 / atol 1e-5, the tolerance of the JAX kernel tests and
    of the card's check (3xTF32 drops terms below 2^-22 of each product,
    and sums run in another order);
(c) the image cache: one image per decoder and parameter version.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.models import decoders as JD
from attentive_dfprior_tpu.ops.pallas.decoder_kernel import fused_mlp_forward as j_fused
from attentive_dfprior_tpu.ops.pallas.decoder_kernel import pack_mlp_params as j_pack
from attentive_dfprior_tpu_torch.models.decoders import init_mlp_decoder
from attentive_dfprior_tpu_torch.models.scene import params_from_numpy
from attentive_dfprior_tpu_torch.ops.cuda.decoder_kernel import (
    TC_CACHE,
    TC_CACHE_SIZE,
    fused_decoder_forward,
    fused_mlp_plain,
    n_tc_weights,
    pack_mlp_params,
    pack_tc_weights,
)

torch.set_num_threads(1)
CONFIGS = [(32, 1), (64, 1), (32, 4)]


def _layout(c_dim):
    """Offsets (floats) of the image's regions, as decoder_mlp.cu reads them."""
    we = 0
    wf = 2 * 64 * 96
    wc = wf + 2 * 160 * c_dim
    b = wc + 2 * 4 * 32 * 32
    bias = b + 3 * 96
    wout = bias + 10 * 32
    bout = wout + 32 * 4
    return dict(we=we, wf=wf, wc=wc, b=b, bias=bias, wout=wout, bout=bout, end=bout + 4)


def _matrix(img, off, rows, k):
    """(rows, K) operand read the way the wgmma descriptors address it:
    128-byte core matrices of 8 rows x 4 K values, K-adjacent core matrices
    128 bytes apart (LBO), 8-row groups K * 32 bytes apart (SBO)."""
    n = torch.arange(rows)[:, None]
    kk = torch.arange(k)[None, :]
    return img[off + ((n // 8) * (k // 4) + kk // 4) * 32 + (n % 8) * 4 + kk % 4]


def _rna_tf32(x):
    """cvt.rna.tf32.f32 on the bit pattern, written on the sign-magnitude
    form: round the magnitude to 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    mag = (mag + 0x1000) & ~0x1FFF
    out = (sign | mag).to(torch.int64)
    out = torch.where(out >= 2**31, out - 2**32, out)
    return out.to(torch.int32).view(torch.float32)


def _fragment_orders(c_dim):
    """K position -> feature for the fc and chain products, from the
    kernel's fragments: A position t of k8 step kk is (row, t), t + 4 is
    (row, t + 4), for t the thread's index in its quad.

    fc: the thread loads features t*c/4 .. t*c/4 + c/4 - 1 of its rows and
    gives step kk the features t*c/4 + 2kk (position t) and + 1 (t + 4).
    chain: the thread's accumulator holds columns 8kk + 2t, 8kk + 2t + 1,
    given to positions t and t + 4 of step kk."""
    fc = torch.empty(c_dim, dtype=torch.long)
    chain = torch.empty(32, dtype=torch.long)
    for t in range(4):
        for kk in range(c_dim // 8):
            fc[8 * kk + t] = t * (c_dim // 4) + 2 * kk
            fc[8 * kk + t + 4] = t * (c_dim // 4) + 2 * kk + 1
        for kk in range(4):
            chain[8 * kk + t] = 8 * kk + 2 * t
            chain[8 * kk + t + 4] = 8 * kk + 2 * t + 1
    return fc, chain


def _emulate(img, p, c, out_dim):
    """The kernel's arithmetic on its weight image."""
    c_dim = c.shape[1]
    off = _layout(c_dim)
    fc_order, chain_order = _fragment_orders(c_dim)

    def mm3(a, hi, rows, k):
        # the lo matrix follows the hi matrix of the same operand
        wh, wl = _matrix(img, hi, rows, k), _matrix(img, hi + rows * k, rows, k)
        ah = _rna_tf32(a)
        al = _rna_tf32(a - ah)
        return (al @ wh.T + ah @ wl.T) + ah @ wh.T

    B = img[off["b"] : off["b"] + 288].reshape(3, 96)
    e = torch.sin((p[:, 0:1] * B[0] + p[:, 1:2] * B[1]) + p[:, 2:3] * B[2])
    e[:, 93:] = 0.0
    eacc = mm3(e, off["we"], 64, 96)  # [W0 | W3[:93]]
    facc = mm3(c[:, fc_order], off["wf"], 160, c_dim)  # [fc0 | ... | fc4]
    bias = img[off["bias"] : off["bias"] + 320].reshape(10, 32)
    h = torch.relu(eacc[:, :32] + bias[0]) + (facc[:, :32] + bias[1])
    for i in range(1, 5):
        acc = mm3(h[:, chain_order], off["wc"] + 2048 * (i - 1), 32, 32)  # hi/lo pairs
        if i == 3:
            acc = eacc[:, 32:] + acc
        h = torch.relu(acc + bias[2 * i]) + (facc[:, 32 * i : 32 * i + 32] + bias[2 * i + 1])
    wout = img[off["wout"] : off["wout"] + 128].reshape(32, 4)[:, :out_dim]
    return h @ wout + img[off["bout"] : off["bout"] + out_dim]


def _jax_decoder(c_dim, out_dim, seed):
    params = JD.init_mlp_decoder(jax.random.PRNGKey(seed), c_dim=c_dim, color=out_dim == 4)
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("c_dim,out_dim", CONFIGS)
def test_tf32_split_and_padding(c_dim, out_dim):
    _, tp = _jax_decoder(c_dim, out_dim, 11)
    img = pack_tc_weights(pack_mlp_params(tp))
    off = _layout(c_dim)
    assert img.numel() == off["end"] == n_tc_weights(c_dim)
    fc_order, chain_order = _fragment_orders(c_dim)
    w = [blk["w"] for blk in tp["pts"]]
    exact = [
        (off["we"], 64, 96, torch.nn.functional.pad(torch.cat([w[0].T, w[3][:93].T]), (0, 3))),
        (off["wf"], 160, c_dim, torch.cat([blk["w"].T for blk in tp["fc_c"]])[:, fc_order]),
    ]
    exact += [(off["wc"] + 2048 * i, 32, 32, m.T[:, chain_order])
              for i, m in enumerate([w[1], w[2], w[3][93:], w[4]])]
    for o, rows, k, ref in exact:
        hi, lo = _matrix(img, o, rows, k), _matrix(img, o + rows * k, rows, k)
        assert not (hi.contiguous().view(torch.int32) & 0x1FFF).any()
        assert not (lo.contiguous().view(torch.int32) & 0x1FFF).any()
        err = ((hi.double() + lo.double()) - ref.double()).abs()
        assert (err <= 2.0**-21 * ref.double().abs()).all()
    # the embedding's pad: zero in B, in both halves of [W0 | W3[:93]]
    B = img[off["b"] : off["b"] + 288].reshape(3, 96)
    assert torch.equal(B[:, :93], tp["B"]) and not B[:, 93:].any()
    for o in (off["we"], off["we"] + 64 * 96):
        assert not _matrix(img, o, 64, 96)[:, 93:].any()


@pytest.mark.parametrize("n", [1, 65, 700])
@pytest.mark.parametrize("c_dim,out_dim", CONFIGS)
def test_kernel_arithmetic_on_image_matches_jax(c_dim, out_dim, n):
    jparams, tp = _jax_decoder(c_dim, out_dim, c_dim + out_dim)
    rng = np.random.default_rng(1000 * c_dim + n)
    p = rng.standard_normal((n, 3)).astype(np.float32)
    c = rng.standard_normal((n, c_dim)).astype(np.float32)
    ref = np.asarray(j_fused(j_pack(jparams), jnp.asarray(p), jnp.asarray(c), block=256, interpret=True))
    img = pack_tc_weights(pack_mlp_params(tp))
    out = _emulate(img, torch.tensor(p), torch.tensor(c), out_dim)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_image_cache_follows_parameter_versions():
    params = init_mlp_decoder(torch.Generator().manual_seed(3), c_dim=32)
    first = TC_CACHE.get(params)
    assert TC_CACHE.get(params) is first  # unchanged weights: the same image
    params["pts"][1]["w"].add_(0.25)  # in place, as the optimizer's copy_
    second = TC_CACHE.get(params)
    assert second is not first
    assert torch.equal(second, pack_tc_weights(pack_mlp_params(params)))
    assert not torch.equal(second, first)
    assert TC_CACHE.get(params) is second
    params["out"]["b"] = params["out"]["b"].clone()  # a replaced leaf (checkpoint load)
    assert TC_CACHE.get(params) is not second
    # a second decoder gets its own entry; the first keeps its image
    other = init_mlp_decoder(torch.Generator().manual_seed(4), c_dim=64)
    third = TC_CACHE.get(params)
    assert TC_CACHE.get(other) is not third and TC_CACHE.get(params) is third
    assert len(TC_CACHE.entries) <= TC_CACHE_SIZE


def test_image_cache_takes_packed_weights():
    # fused_mlp_forward's weights: the PackedMLP's five tensors are the leaves
    packed = pack_mlp_params(init_mlp_decoder(torch.Generator().manual_seed(7), c_dim=32, color=True))
    first = TC_CACHE.get(packed)
    assert TC_CACHE.get(packed) is first
    assert torch.equal(first, pack_tc_weights(packed))
    packed.bout.add_(1.0)
    second = TC_CACHE.get(packed)
    assert second is not first and torch.equal(second, pack_tc_weights(packed))


@pytest.mark.parametrize("c_dim,out_dim", CONFIGS)
def test_fused_decoder_forward_cpu_is_the_plain_mlp(c_dim, out_dim):
    params = init_mlp_decoder(torch.Generator().manual_seed(5), c_dim=c_dim, color=out_dim == 4)
    g = torch.Generator().manual_seed(6)
    p, c = torch.randn((50, 3), generator=g), torch.randn((50, c_dim), generator=g)
    out = fused_decoder_forward(params, p, c)
    assert out.shape == (50, out_dim)
    assert torch.equal(out, fused_mlp_plain(pack_mlp_params(params), p, c))

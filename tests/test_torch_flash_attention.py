"""The port's flash attention: its plain version against the reference's
Pallas kernel (interpret mode) on the CPU, and the CUDA kernel against
the plain version on the card.

Tolerances are those of ``tests/test_kernels.py``: 2e-6 in fp32 (sums
over the keys are taken in another order) and 2e-2 in bf16 (one output
rounding of a slightly different fp32 value).

The card's tests import neither JAX nor the reference, so that
``python -m pytest -m gpu tests/test_torch_flash_attention.py`` runs on a
machine with a card and no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (default_scale,
                                                 flash_attention, mha_plain)

torch.set_num_threads(1)

SHAPES = [
    # b, hq, hkv, sq, sk, d, causal  (as tests/test_kernels.py)
    (2, 4, 4, 128, 128, 64, False),
    (2, 4, 2, 128, 128, 64, True),
    (1, 8, 1, 200, 200, 64, True),
    (2, 4, 1, 64, 384, 128, True),
    (1, 2, 2, 1, 300, 80, True),       # decode
    (1, 4, 2, 257, 512, 32, True),     # non-aligned q
]
TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def ref_flash(q, k, v, *, causal, dtype="float32"):
    """The reference's Pallas kernel (interpret mode) on numpy inputs."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention
    return np.asarray(flash_attention(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)),
        causal=causal), np.float32)


def _inputs(shape, seed):
    b, hq, hkv, sq, sk, d, _ = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _torch(x, dtype, device="cpu"):
    return torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel(shape, dtype):
    causal = shape[-1]
    q, k, v = _inputs(shape, SHAPES.index(shape))
    want = ref_flash(q, k, v, causal=causal, dtype=dtype)
    got = mha_plain(*(_torch(x, dtype) for x in (q, k, v)), causal=causal)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_rows_that_see_no_key_are_zero():
    """Causal with Sq > Sk: the first Sq - Sk queries sit before every
    key.  The Pallas kernel outputs 0 there; so does the plain version."""
    shape = (1, 4, 2, 96, 40, 64, True)
    q, k, v = _inputs(shape, 7)
    want = ref_flash(q, k, v, causal=True)
    got = mha_plain(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
    assert not np.any(got[:, :, :56]) and not np.any(want[:, :, :56])
    assert np.all(np.abs(got[:, :, 56:]).sum(-1) > 0)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)


def test_wrapper_takes_the_plain_version_on_cpu():
    q, k, v = map(torch.from_numpy, _inputs(SHAPES[2], 3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before      # no kernel on the CPU
    torch.testing.assert_close(got, mha_plain(q, k, v, causal=True),
                               atol=0, rtol=0)


@pytest.mark.parametrize("grad_of", ["q", "k", "v"])
def test_wrapper_refuses_autograd(grad_of):
    """Neither kernel has a backward, nor has the reference's (``jax.grad``
    through its Pallas kernel raises): a call autograd would
    differentiate raises on every device, before any route is taken;
    under ``no_grad`` and ``inference_mode`` the same inputs run."""
    q, k, v = map(torch.from_numpy, _inputs(SHAPES[1], 4))
    args = dict(q=q, k=k, v=v)
    args[grad_of] = args[grad_of].clone().requires_grad_(True)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward.*use_flash_kernel"):
        flash_attention(args["q"], args["k"], args["v"], causal=True)
    want = mha_plain(q, k, v, causal=True)
    with torch.no_grad():
        got = flash_attention(args["q"], args["k"], args["v"], causal=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with torch.inference_mode():
        got = flash_attention(args["q"], args["k"], args["v"], causal=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert flash_attention.launches == before


def test_plain_reads_strided_views():
    """The model hands (B,H,S,D) views of (B,S,H,D) tensors."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((2, 33, 8, 16), np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 33, 2, 16), np.float32))
    got = mha_plain(q.transpose(1, 2), kv.transpose(1, 2),
                    kv.transpose(1, 2), causal=True)
    want = mha_plain(q.transpose(1, 2).contiguous(),
                     kv.transpose(1, 2).contiguous(),
                     kv.transpose(1, 2).contiguous(), causal=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_default_scale_is_fp32_rounded():
    for d in (16, 64, 80, 128):
        assert default_scale(d) == float(np.float32(1.0 / d ** 0.5))


# -- the CUDA kernel against its plain version (card only) -------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + [(1, 4, 2, 96, 40, 64, True)])
def test_kernel_matches_plain_on_card(cuda, shape, dtype):
    causal = shape[-1]
    q, k, v = (_torch(x, dtype, cuda) for x in _inputs(shape, 5))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = mha_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_kernel_reads_transposed_views_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 130, 8, 64), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    kv = torch.randn((2, 130, 2, 64), generator=g, device=cuda,
                     dtype=torch.bfloat16)
    qt, kt = q.transpose(1, 2), kv.transpose(1, 2)
    got = flash_attention(qt, kt, kt, causal=True)
    want = mha_plain(qt, kt, kt, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 256), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())

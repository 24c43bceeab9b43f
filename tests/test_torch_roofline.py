"""The port's roofline (`repro_torch.perfmodel.roofline`): the unit tests
of ``tests/test_perfmodel.py`` with the H100 constants in place of the
TPU v5e's, and the parameter counts of all ten full configs on meta
tensors equal to the reference's on its ``jax.eval_shape`` trees."""
import jax
import pytest
import torch

from repro.configs import registry as ref_cfgs
from repro.models.registry import get_model as ref_model
from repro.perfmodel import roofline as ref_roofline
from repro_torch.configs import registry as cfgs
from repro_torch.models.registry import get_model
from repro_torch.perfmodel import roofline


def test_h100_constants():
    """The H100 SXM's data-sheet numbers at 700 W; no TPU constant."""
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == {"host": 450e9, "pod": 50e9,
                                "multipod": 50e9}
    assert not hasattr(roofline, "ICI_BW")


def test_roofline_terms_and_bottleneck():
    r = roofline.make(
        "a", "s", "pod", 256,
        cost={"flops": 989e12, "bytes accessed": 3.35e12 * 2},
        collectives={"total_bytes": 50e9 * 0.5},
        model_flops=989e12 * 256 * 0.4,
        bytes_per_device=1e9)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.bottleneck == "memory"
    assert r.useful_ratio == pytest.approx(0.4)
    host = roofline.make("a", "s", "host", 1, cost={"flops": 989e12 * 3},
                         collectives={"total_bytes": 450e9},
                         model_flops=0.0, bytes_per_device=0.0)
    assert (host.compute_s, host.memory_s, host.collective_s,
            host.bottleneck) == (pytest.approx(3.0), 0.0,
                                 pytest.approx(1.0), "compute")
    assert set(r.as_dict()) == set(ref_roofline.Roofline.__dataclass_fields__)


def test_model_flops():
    assert roofline.model_flops("train", 10, 100) == 6000
    assert roofline.model_flops("prefill", 10, 100) == 2000
    assert roofline.model_flops("decode", 10, 100) == 2000


def test_active_params_moe():
    struct = dict(
        we_gate=torch.empty((8, 4, 4), device="meta"),
        dense=torch.empty((4, 4), device="meta"))
    n = roofline.count_active_params(struct, top_k=2, n_experts=8)
    assert n == 8 * 16 * 2 // 8 + 16
    assert roofline.count_active_params(struct, 2, 0) == 8 * 16 + 16
    assert roofline.count_params_struct(struct) == 8 * 16 + 16


@pytest.mark.parametrize("arch", cfgs.ARCH_ORDER)
def test_param_counts_equal_the_references(arch):
    cfg = cfgs.get_config(arch)
    params = get_model(cfg).init(0, device="meta")
    rcfg = ref_cfgs.get_config(arch)
    struct = jax.eval_shape(ref_model(rcfg).init, jax.random.PRNGKey(0))
    assert roofline.count_params_struct(params) == \
        ref_roofline.count_params_struct(struct)
    assert roofline.count_active_params(params, cfg.top_k,
                                        cfg.n_experts) == \
        ref_roofline.count_active_params(struct, rcfg.top_k,
                                         rcfg.n_experts)

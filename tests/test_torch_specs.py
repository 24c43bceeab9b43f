"""The port's spec trees against the JAX package's, for all ten configs
(full and smoke): ``api.param_specs()``, ``api.cache_specs(shard_seq=
True / False)``, `train.optimizer.state_specs` and `train.step.
batch_specs` equal the reference's trees leaf for leaf, and every leaf
names as many logical axes as the port's meta leaf has dims."""
import pytest
import torch

from repro.configs import registry as ref_cfgs
from repro.models.registry import get_model as ref_model
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch.configs import registry as cfgs
from repro_torch.models.registry import get_model
from repro_torch.parallel.axes import is_spec_leaf
from repro_torch.train import optimizer as opt
from repro_torch.train import step as tstep

CASES = [(arch, which) for arch in cfgs.ARCH_ORDER
         for which in ("config", "smoke")]


def _apis(arch, which):
    get = cfgs.get_config if which == "config" else cfgs.get_smoke
    rget = ref_cfgs.get_config if which == "config" else ref_cfgs.get_smoke
    return get_model(get(arch)), ref_model(rget(arch))


def assert_congruent(spec, tree, path="specs"):
    """``spec``'s leaves sit where ``tree``'s tensors do, one logical
    name per dim."""
    if is_spec_leaf(spec):
        assert isinstance(tree, torch.Tensor), path
        assert len(spec) == tree.dim(), (path, spec, tuple(tree.shape))
        return
    assert isinstance(spec, dict) and isinstance(tree, dict), path
    assert sorted(spec) == sorted(tree), (path, sorted(spec), sorted(tree))
    for k in spec:
        assert_congruent(spec[k], tree[k], f"{path}/{k}")


@pytest.mark.parametrize("arch,which", CASES)
def test_param_and_state_specs_equal_the_references(arch, which):
    api, rapi = _apis(arch, which)
    specs = api.param_specs()
    assert specs == rapi.param_specs()
    params = api.init(0, device="meta")
    assert_congruent(specs, params)
    state_specs = opt.state_specs(specs)
    assert state_specs == ref_opt.state_specs(rapi.param_specs())
    state = opt.init_state(opt.AdamWConfig(), params)
    assert_congruent(state_specs, state)


@pytest.mark.parametrize("arch,which", CASES)
def test_cache_and_batch_specs_equal_the_references(arch, which):
    api, rapi = _apis(arch, which)
    cache = api.init_cache(2, 16, device="meta")
    for shard_seq in (True, False):
        specs = api.cache_specs(shard_seq=shard_seq)
        assert specs == rapi.cache_specs(shard_seq=shard_seq)
        assert_congruent(specs, cache)
    assert api.cache_specs() == api.cache_specs(shard_seq=True)
    bspecs = tstep.batch_specs(api)
    assert bspecs == ref_step.batch_specs(rapi)
    cfg = api.cfg
    batch = dict(tokens=torch.zeros((2, 8), device="meta"),
                 labels=torch.zeros((2, 8), device="meta"))
    if api.needs_ctx:
        batch["ctx"] = torch.zeros((2, cfg.n_ctx_tokens, cfg.d_model),
                                   device="meta")
    assert_congruent(bspecs, batch)

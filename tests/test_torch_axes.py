"""The port's logical-axis rules (`repro_torch.parallel.axes`) and meshes
(`repro_torch.launch.mesh`) against the JAX package's.

The eight cases of ``tests/test_sharding.py`` on the port's device-less
`Mesh`, with the same expected specs; a seeded random check that the
port's `resolve` equals the reference's on random names, shapes and mesh
sizes under every preset; the presets and `rules_for` equal to the
reference's; `resolve_tree` leaf for leaf against the reference's
`resolve`.
"""
import math
import threading

import numpy as np
import pytest

from repro.launch import mesh as ref_mesh
from repro.parallel import axes as ref
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh, rules_for)
from repro_torch.parallel.axes import (P, local_shape, multi_pod_rules,
                                       resolve, resolve_tree, serve_rules,
                                       serving_mode, sharding_rules,
                                       single_pod_rules)

NAMES = ("batch", "fsdp", "embed", "heads", "kv_heads", "mlp", "vocab",
         "experts", "seq", "state", "kv_seq", None)


class RefMesh:
    """The reference tests' shape-only mesh (``tests/test_sharding.py``)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def with_rules(fn, multi=False):
    mesh = (Mesh(("pod", "data", "model"), (2, 16, 16)) if multi
            else Mesh(("data", "model"), (16, 16)))
    rules = multi_pod_rules() if multi else single_pod_rules()
    with sharding_rules(mesh, rules):
        return fn()


def test_divisible_dims_shard():
    spec = with_rules(lambda: resolve(
        ("fsdp", "heads", None), (8192, 64, 128)))
    assert spec == P("data", "model")


def test_indivisible_heads_replicate():
    # whisper: 20 heads on a 16-way model axis -> replicated
    spec = with_rules(lambda: resolve(
        ("fsdp", "heads", None), (1280, 20, 64)))
    assert spec == P("data")


def test_dedup_first_dim_wins():
    spec = with_rules(lambda: resolve(
        ("experts", "fsdp", "mlp"), (128, 7168, 4864)))
    assert spec == P("model", "data")


def test_grok_fallback_ep_to_tp():
    spec = with_rules(lambda: resolve(
        ("experts", "fsdp", "mlp"), (8, 6144, 32768)))
    assert spec == P(None, "data", "model")


def test_kv_seq_flash_decoding_rules():
    spec = with_rules(lambda: resolve(
        ("batch", "kv_seq", "kv_heads", None), (128, 32768, 8, 128)))
    assert spec == P("data", "model")
    spec = with_rules(lambda: resolve(
        ("batch", "kv_seq", "kv_heads", None), (1, 524288, 8, 128)))
    assert spec == P(None, ("data", "model"))


def test_multi_pod_batch_spans_pod_and_data():
    spec = with_rules(lambda: resolve(
        ("batch", None, None), (256, 4096, 1024)), multi=True)
    assert spec == P(("pod", "data"))


def test_no_rules_is_noop():
    assert resolve(("batch", None)) == P()
    assert resolve(("batch", None), (4, 4)) == P()


def test_trailing_nones_trimmed():
    spec = with_rules(lambda: resolve((None, "heads", None), (1, 64, 64)))
    assert spec == P(None, "model")


PRESETS = {
    "single": (single_pod_rules, ref.single_pod_rules, ("data", "model")),
    "multi": (multi_pod_rules, ref.multi_pod_rules,
              ("pod", "data", "model")),
    "serve": (serve_rules, ref.serve_rules, ("data", "model")),
    "serve_multi": (lambda: serve_rules(multi_pod=True),
                    lambda: ref.serve_rules(multi_pod=True),
                    ("pod", "data", "model")),
}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_presets_equal_the_references(preset):
    ours, theirs, _ = PRESETS[preset]
    assert ours() == theirs()


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_resolve_equals_the_reference_on_random_cases(preset):
    ours, theirs, axes = PRESETS[preset]
    rng = np.random.default_rng(sorted(PRESETS).index(preset))
    for case in range(300):
        sizes = tuple(int(rng.choice([1, 2, 3, 4, 8, 16])) for _ in axes)
        ndim = int(rng.integers(0, 6))
        names = tuple(NAMES[i] for i in rng.integers(0, len(NAMES), ndim))
        shape = tuple(int(rng.choice([1, 2, 3, 5, 8, 12, 16, 20, 64, 96,
                                      128, 256, 4096, 32768]))
                      for _ in range(ndim))
        with sharding_rules(Mesh(axes, sizes), ours()):
            got = resolve(names, shape)
            got_unshaped = resolve(names)
        with ref.sharding_rules(RefMesh(sizes, axes), theirs()):
            want = ref.resolve(names, shape)
            want_unshaped = ref.resolve(names)
        assert tuple(got) == tuple(want), (case, names, shape, sizes)
        assert tuple(got_unshaped) == tuple(want_unshaped), (case, names)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("serving", [False, True])
def test_rules_for_equals_the_reference(multi, serving):
    mesh = make_production_mesh(multi_pod=multi)
    want = ref_mesh.rules_for(
        RefMesh(mesh.shape, mesh.axis_names), serving=serving)
    assert rules_for(mesh, serving=serving) == want
    with sharding_rules(mesh, rules_for(mesh, serving=serving)):
        assert serving_mode() is serving
    assert not serving_mode()


def test_meshes():
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (pod.axis_names, pod.shape, pod.size, pod.devices) == (
        ("data", "model"), (16, 16), 256, None)
    assert (multi.axis_names, multi.shape, multi.size) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    host = make_host_mesh(device="cpu")
    assert (host.shape, host.size, str(host.devices[0])) == ((1, 1), 1,
                                                            "cpu")


def test_rules_are_per_thread_and_restored():
    mesh = make_production_mesh()
    seen = []
    with sharding_rules(mesh, single_pod_rules()):
        t = threading.Thread(target=lambda: seen.append(
            resolve(("batch",), (256,))))
        t.start()
        t.join()
        assert resolve(("batch",), (256,)) == P("data")
        with sharding_rules(mesh, serve_rules()):
            assert serving_mode()
        assert not serving_mode()
    assert seen == [P()]
    assert resolve(("batch",), (256,)) == P()


def test_resolve_tree_and_local_shapes_on_a_param_tree():
    """tinyllama-1.1b's full spec tree on meta tensors, under the pod's
    training and serving rules: every leaf the reference's `resolve`,
    and each local shape the global one over the axes' sizes."""
    import jax
    from repro.configs.registry import get_config as ref_config
    from repro.models.registry import get_model as ref_model
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.tree import leaves

    api = get_model(get_config("tinyllama-1.1b"))
    params = api.init(0, device="meta")
    rapi = ref_model(ref_config("tinyllama-1.1b"))
    mesh = make_production_mesh()
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    for serving in (False, True):
        rules = rules_for(mesh, serving=serving)
        with sharding_rules(mesh, rules):
            got = resolve_tree(api.param_specs(), params)
        with ref.sharding_rules(RefMesh(mesh.shape, mesh.axis_names),
                                rules):
            want = jax.tree_util.tree_map(
                lambda names, t: ref.resolve(names, t.shape),
                rapi.param_specs(), params, is_leaf=ref_is_leaf)
        flat_want = jax.tree_util.tree_leaves(
            want, is_leaf=lambda x: isinstance(x, ref.P))
        assert [tuple(s) for s in leaves(got)] == [tuple(s)
                                                  for s in flat_want]
        for spec, t in zip(leaves(got), leaves(params)):
            loc = local_shape(spec, t.shape, mesh)
            for i, dim in enumerate(t.shape):
                entry = spec[i] if i < len(spec) else None
                axes = (entry,) if isinstance(entry, str) else entry or ()
                assert loc[i] * math.prod(sizes[a] for a in axes) == dim


def ref_is_leaf(x):
    return isinstance(x, tuple) and all(isinstance(n, (str, type(None)))
                                        for n in x)

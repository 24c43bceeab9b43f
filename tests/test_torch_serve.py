"""The port's serving engine: the reference's continuous-batching cases,
tokens equal to the reference Engine's, and the slot reset that keeps
in-flight requests' caches when ``n_layers == n_slots``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import ModelConfig as RefConfig
from repro.models.registry import get_model as ref_get_model
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro_torch.launch import serve as launch_serve
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import get_model, params_from_numpy
from repro_torch.serve.engine import Engine, Request, SlotPool

torch.set_num_threads(1)

CFG = ModelConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab=128, dtype=torch.float32)


def setup():
    api = get_model(CFG)
    return api, api.init(0, device="cpu")


def engine(n_slots, max_seq=64):
    api, params = setup()
    return Engine(api, params, n_slots=n_slots, max_seq=max_seq,
                  device="cpu")


# -- the reference's engine cases --------------------------------------------

def test_engine_completes_all_requests():
    eng = engine(3)
    for i in range(7):
        eng.submit(Request(rid=i, prompt=[1 + i, 2, 3], max_new=5))
    done = eng.run()
    assert len(done) == 7
    assert all(len(r.out) == 5 for r in done)


def test_engine_matches_single_stream_decode():
    """A request decoded through the batched engine produces the same
    tokens as a dedicated single-sequence greedy decode."""
    api, params = setup()
    prompt = [5, 9, 2, 17]
    eng = Engine(api, params, n_slots=2, max_seq=64, device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_new=6))
    eng.submit(Request(rid=1, prompt=[3, 3, 3], max_new=6))
    done = eng.run()
    out_engine = next(r.out for r in done if r.rid == 0)
    cache = api.init_cache(1, 64, device="cpu")
    out_ref = []
    for t in prompt:
        logits, cache = api.decode(params, cache, torch.tensor([t]))
    for _ in range(6):
        nxt = int(torch.argmax(logits[0]))
        out_ref.append(nxt)
        logits, cache = api.decode(params, cache, torch.tensor([nxt]))
    assert out_engine == out_ref


def test_slot_reuse_resets_state():
    """A slot reused by a second request must not leak the first
    request's KV cache."""
    eng = engine(1)
    eng.submit(Request(rid=0, prompt=[7, 8, 9], max_new=4))
    eng.submit(Request(rid=1, prompt=[7, 8, 9], max_new=4))
    done = eng.run()
    assert len(done) == 2
    assert done[0].out == done[1].out     # identical prompt -> identical out


def test_slotpool_fifo_and_recycling():
    pool = SlotPool(2)
    for i in range(5):
        pool.submit(i)
    assert pool.admit() == [(0, 0), (1, 1)]    # FIFO into slot order
    assert pool.admit() == []                  # no free slot -> no-op
    assert pool.pending() and len(pool.queue) == 3
    pool.free(1)
    assert pool.admit() == [(1, 2)]            # recycled slot, next in line
    assert [r for _, r in pool.active()] == [0, 2]
    for s, _ in pool.active():
        pool.free(s)
    assert pool.admit() == [(0, 3), (1, 4)]
    pool.free(0)
    pool.free(1)
    assert not pool.pending()


def test_slotpool_validates_n_slots():
    with pytest.raises(ValueError):
        SlotPool(0)


def test_submit_beyond_n_slots_queues():
    eng = engine(2)
    for i in range(6):
        eng.submit(Request(rid=i, prompt=[1 + i], max_new=3))
    eng.tick()
    assert sum(r is not None for r in eng.slots) == 2
    assert len(eng.queue) == 4                 # surplus queued, not lost
    done = eng.run()
    assert sorted(r.rid for r in done) == list(range(6))
    assert all(len(r.out) == 3 for r in done)


def test_zero_length_request_rejected():
    eng = engine(1)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(rid=0, prompt=[], max_new=4))
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(Request(rid=1, prompt=[3], max_new=0))
    assert not eng.pool.pending()


def test_run_max_ticks_resumes():
    eng = engine(1)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=[5 + i, 2], max_new=4))
    done = eng.run(max_ticks=3)
    assert done == []
    assert len(eng.queue) == 2
    partial = eng.slots[0]
    assert partial.rid == 0 and 0 < len(partial.out) < 4
    done += eng.run()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out) == 4 for r in done)


def test_same_tick_admit_and_complete_collected():
    eng = engine(2)
    eng.submit(Request(rid=0, prompt=[9], max_new=1))
    done = eng.run()
    assert [r.rid for r in done] == [0]
    assert len(done[0].out) == 1 and done[0].done
    assert not eng.pool.pending()


# -- against the reference Engine ----------------------------------------------

def _requests(cls, n, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=[int(t) for t in rng.integers(
        1, vocab, int(rng.integers(1, 7)))], max_new=int(rng.integers(1, 8)))
        for i in range(n)]


@pytest.mark.parametrize("n_layers,n_slots,max_seq", [(3, 2, 64), (2, 3, 12)])
def test_tokens_equal_the_reference_engine(n_layers, n_slots, max_seq):
    """fp32, ``n_layers != n_slots`` (see the next test).  With
    ``max_seq`` 12, free slots keep decoding past the end of their cache
    and exercise the clamped cache write."""
    kw = dict(name="t", n_layers=n_layers, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab=128, qkv_bias=True)
    rcfg = RefConfig(**kw, dtype=jnp.float32)
    cfg = ModelConfig(**kw, dtype=torch.float32)
    rng = np.random.default_rng(7)
    tree = jax.tree_util.tree_map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        + (np.asarray(a) == 1), ref_get_model(rcfg).init(
            jax.random.PRNGKey(0)))
    ref = RefEngine(ref_get_model(rcfg),
                    jax.tree_util.tree_map(jnp.asarray, tree),
                    n_slots=n_slots, max_seq=max_seq)
    port = Engine(get_model(cfg), params_from_numpy(cfg, tree, "cpu"),
                  n_slots=n_slots, max_seq=max_seq, device="cpu")
    for r in _requests(RefRequest, 7, 128):
        ref.submit(r)
    for r in _requests(Request, 7, 128):
        port.submit(r)
    for _ in range(200):
        if not ref.pool.pending():
            break
        done_r = [r.rid for r in ref.tick()]
        done_p = [r.rid for r in port.tick()]
        assert done_p == done_r
        assert ([None if r is None else (r.rid, r.out) for r in port.slots]
                == [None if r is None else (r.rid, r.out) for r in ref.slots])
    assert not ref.pool.pending() and not port.pool.pending()


def test_reset_keeps_in_flight_caches_when_layers_equal_slots():
    """Re-admitting slot 0 zeroes slot 0 only, along the batch axis,
    even when ``n_layers == n_slots`` (the reference's shape test would
    take the layer axis there and zero layer 0 of every slot)."""
    eng = engine(2)                           # CFG has 2 layers
    eng.submit(Request(rid=0, prompt=[4], max_new=2))
    eng.submit(Request(rid=1, prompt=[5, 6, 7, 8], max_new=6))
    eng.submit(Request(rid=2, prompt=[9], max_new=2))
    while eng.slots[0] is None or eng.slots[0].rid != 2:
        eng.tick()                            # rid 2 takes slot 0 here
    before = {n: eng.cache[n][:, 1].clone() for n in ("k", "v")}
    assert float(before["k"].abs().sum()) > 0
    eng._reset_slot(0)
    for n in ("k", "v"):
        torch.testing.assert_close(eng.cache[n][:, 1], before[n],
                                   atol=0, rtol=0)
        assert not eng.cache[n][:, 0].any()
    assert eng.cache["length"][1] > 0 and eng.cache["length"][0] == 0


def test_argmax_takes_the_lowest_index_on_ties():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    assert logits.argmax(-1).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)).tolist() \
        == [1, 0]


def test_engine_serves_where_its_params_lie():
    api, params = setup()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(api, params, n_slots=2)
    with pytest.raises(ValueError, match="params are on"):
        Engine(api, params, n_slots=2, device="meta")


def test_launch_serve_on_cpu(capsys):
    done = launch_serve.main(["--arch", "tinyllama-1.1b", "--smoke",
                              "--device", "cpu", "--requests", "3",
                              "--slots", "2"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out) == 8 for r in done)
    assert "3 requests, 24 tokens" in capsys.readouterr().out


# -- every family -------------------------------------------------------------

FAMILIES = ["dense", "moe", "xlstm", "mamba", "hybrid", "vlm", "audio"]


def family_engine(fam, n_slots=2, max_seq=32):
    """An engine over the reference's small ``FAMS[fam]`` config (fp32,
    the drawn weights of `_torch_families.ref_tree`, the vision model's
    gates opened to tanh(2)) with a per-slot ctx for the ctx families."""
    from _torch_families import configs, ref_tree

    rcfg, cfg = configs(fam, use_flash_kernel=True)
    api = get_model(cfg)
    params = params_from_numpy(cfg, ref_tree(rcfg), device="cpu")
    if fam == "vlm":
        params["cross"]["gate_attn"].fill_(2.0)
        params["cross"]["gate_mlp"].fill_(2.0)
    return Engine(api, params, n_slots=n_slots, max_seq=max_seq,
                  ctx=slot_ctx(api, n_slots), device="cpu")


def slot_ctx(api, n_slots):
    """The ctx families' per-slot context (None for the others)."""
    if not api.needs_ctx:
        return None
    cfg = api.cfg
    return torch.from_numpy(np.random.default_rng(3).standard_normal(
        (n_slots, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32))


def greedy(eng, slot, prompt, n):
    """``prompt`` then ``n`` greedy tokens decoded straight through
    ``api.decode`` in row ``slot`` of a cache fresh from `init_cache`
    (and `fill_ctx` with the engine's ctx), the other rows fed token 0:
    no admission, no reset."""
    api = eng.api
    cache = api.init_cache(eng.n_slots, eng.max_seq, device="cpu")
    if api.needs_ctx:
        cache = api.fill_ctx(eng.params, cache, slot_ctx(api, eng.n_slots))
    toks = torch.zeros(eng.n_slots, dtype=torch.int32)
    out = []
    for t in prompt + [None] * n:
        if t is None:
            out.append(int(logits[slot].argmax()))
            t = out[-1]
        toks[slot] = t
        logits, cache = api.decode(eng.params, cache, toks)
    return out[:n]


@pytest.mark.parametrize("fam", FAMILIES)
def test_recycled_slot_gives_the_tokens_of_a_fresh_engine(fam):
    """Request 2 lands in slot 1 after request 1 has used it; a fresh
    engine serving requests 0 and 2 puts it in a slot never used.  The
    tokens are equal, and equal to a greedy decode straight from a fresh
    cache: the reset restored every recurrent and KV leaf and kept the
    slot's cross K/V."""
    reqs = [([7, 3, 9, 4], 8), ([11, 5], 2), ([2, 8, 6], 5)]
    used = family_engine(fam)
    for i, (prompt, n) in enumerate(reqs):
        used.submit(Request(rid=i, prompt=prompt, max_new=n))
    done = {r.rid: r for r in used.run()}
    fresh = family_engine(fam)
    for i in (0, 2):
        fresh.submit(Request(rid=i, prompt=reqs[i][0], max_new=reqs[i][1]))
    again = {r.rid: r for r in fresh.run()}
    assert sorted(done) == [0, 1, 2] and sorted(again) == [0, 2]
    assert done[2].out == again[2].out == greedy(used, 1, *reqs[2])
    assert done[0].out == again[0].out == greedy(used, 0, *reqs[0])


@pytest.mark.parametrize("fam", FAMILIES)
def test_reset_restores_the_fresh_cache(fam):
    """After some ticks, resetting slot 0 makes its every leaf what
    `init_cache` gives (mLSTM and sLSTM stabilisers at -1e30, not 0),
    leaves slot 1 as it was, and keeps both slots' cross K/V."""
    eng = family_engine(fam)
    eng.submit(Request(rid=0, prompt=[4, 5, 6], max_new=3))
    eng.submit(Request(rid=1, prompt=[9, 8], max_new=6))
    for _ in range(4):
        eng.tick()
    fresh = eng.api.init_cache(2, 32, device="cpu")
    axes = eng.api.batch_axes()

    def leaves(tree, ax, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, ax[k], f"{path}/{k}")
            else:
                yield f"{path}/{k}", v, ax[k]

    before = {p: v.clone() for p, v, _ in leaves(eng.cache, axes)}
    eng._reset_slot(0)
    new = {p: (v, a) for p, v, a in leaves(eng.cache, axes)}
    ctx_leaves = 0
    for p, want, _ in leaves(fresh, axes):
        got, ax = new[p]
        if ax is None:
            ctx_leaves += 1
            assert torch.equal(got, before[p]) and got.abs().sum() > 0, p
            continue
        b = ax
        assert torch.equal(got.select(b, 0), want.select(b, 0)), p
        assert torch.equal(got.select(b, 1), before[p].select(b, 1)), p
    assert ctx_leaves == (2 if eng.api.needs_ctx else 0)
    if fam == "xlstm":
        assert (eng.cache["mlstm"]["m"][:, 0] == -1e30).all()


@pytest.mark.parametrize("fam", ["vlm", "audio"])
def test_cross_cache_survives_admission(fam):
    eng = family_engine(fam, n_slots=1)
    xk, xv = eng.cache["xk"].clone(), eng.cache["xv"].clone()
    assert xk.abs().sum() > 0
    for i in range(2):
        eng.submit(Request(rid=i, prompt=[3 + i, 4], max_new=2))
    assert len(eng.run()) == 2
    assert torch.equal(eng.cache["xk"], xk) and torch.equal(
        eng.cache["xv"], xv)


def test_engine_checks_the_ctx():
    from _torch_families import configs

    for fam, ctx in (("vlm", None), ("dense", torch.zeros(2, 6, 32))):
        _, cfg = configs(fam)
        api = get_model(cfg)
        with pytest.raises(ValueError, match="ctx"):
            Engine(api, api.init(0, device="cpu"), n_slots=2, ctx=ctx,
                   device="cpu")


@pytest.mark.parametrize("arch", ["arctic-480b", "grok-1-314b", "xlstm-1.3b",
                                  "zamba2-2.7b", "llama-3.2-vision-11b",
                                  "whisper-large-v3"])
def test_launch_serves_every_family(arch, capsys):
    done = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "2", "--slots", "2"])
    assert sorted(r.rid for r in done) == [0, 1]
    assert all(len(r.out) == 8 for r in done)
    assert "2 requests, 16 tokens" in capsys.readouterr().out

"""The partitioned recurrent and cross-attention models' values against
the plain model's.

`tests/test_torch_partition.py` holds the partitioned dry-run's FLOPs,
args and collectives against the reference; the fake process group it
counts over moves no data, so a wrong slice offset or gate order that
keeps every op's shape would pass there.  Here each rank of a small
``(data, model)`` mesh runs xlstm's and zamba2's partitioned forward,
decode and backward over ``gloo`` on the CPU (`tests/_sharded_blocks.py`,
one process a rank), so every per-rank plan of `models.xlstm` and
`models.mamba2` (the in-projection's pieces moved by one all-to-all, the
conv's channels, C.B^T on the state's share, the mLSTM's
sequence-parallel rows, the sLSTM's state gathered every step, the
shared block's ``w_cat`` permuted between the mesh's axes) moves real
values.  fp32 compute: the values differ from the plain model's only by
the order of sums.

xlstm runs on a 1 x 8 mesh: its 4 heads cannot split 8 model ranks (the
sequence-parallel fallback, as on the pod's 16), and the chunk's 128
rows and the sLSTM's head width split 8 ways; once more at 1,040 rows,
past one mLSTM chunk (the gates and the projections on the whole rows,
the loop's output on each rank's share of the value dims), and at both
lengths under ``REPRO_NO_SP`` (the scores summed over the value dims'
shares, each rank's block of one head); there its first mLSTM block's
update and its gradients are held alone too (`UPDATE_TOL`), since at
init the block moves the logits too little for `TOL` to see its plan.
zamba2 runs on a 2 x 2 mesh: data and model ranks both, and a square
mesh for the permuted shard; once more under ``REPRO_SP_RESIDUAL`` (the
residual's rows split over ``model`` through the Mamba2 blocks, C.B^T on
each rank's chunks), its first Mamba2 block's update and gradients held
alone too.  whisper (5 heads on 2 model ranks: the sequence-parallel
attention; vocab 129: the undivided vocab's logits) and the vision model
(4 query heads over 1 KV head: each rank's KV heads of the context) run
on a 2 x 2 mesh too, whisper once more at 1,040 rows over 1,031 frames,
past one attention chunk (the projections whole, each weight's gradient
on the rank's share, the frames padded to two chunks).
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
XLSTM = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=128,
             n_layers=2, slstm_every=2)
ZAMBA2 = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
              n_layers=2, attn_every=2, ssm_state=16, ssm_head_dim=16,
              d_head=16)
VLM = dict(d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=128,
           n_layers=4, cross_attn_every=2, n_ctx_tokens=8)
CASES = {
    "xlstm": dict(arch="xlstm-1.3b", mesh=(1, 8), batch=2, seq=16,
                  cfg=XLSTM,
                  # heads too few for the model axis run whole on every
                  # model rank: the scores split over the value dims, at
                  # 16 rows and past one mLSTM chunk (here, not in
                  # xlstm-long's run: each run's 1,040 sLSTM steps of
                  # collectives are what a case's time goes to)
                  extras=dict(
                      no_sp_xlstm=dict(arch="xlstm-1.3b", batch=2, seq=16,
                                       cfg=XLSTM, env={"REPRO_NO_SP": "1"}),
                      no_sp_xlstm_long=dict(arch="xlstm-1.3b", batch=2,
                                            seq=1040, cfg=XLSTM,
                                            env={"REPRO_NO_SP": "1"}))),
    # more rows than one mLSTM chunk (1,024): the gates and the
    # projections on the whole rows, the loop's output on each rank's
    # share of the value dims
    "xlstm-long": dict(arch="xlstm-1.3b", mesh=(1, 8), batch=2, seq=1040,
                       cfg=XLSTM),
    "zamba2": dict(arch="zamba2-2.7b", mesh=(2, 2), batch=2, seq=16,
                   cfg=ZAMBA2,
                   # the residual's rows over ``model`` through the Mamba2
                   # blocks, the fold and the shared block
                   extras=dict(sp_residual_zamba2=dict(
                       arch="zamba2-2.7b", batch=2, seq=16, cfg=ZAMBA2,
                       env={"REPRO_SP_RESIDUAL": "1"}))),
    "whisper": dict(arch="whisper-large-v3", mesh=(2, 2), batch=2, seq=16,
                    cfg=dict(d_model=80, n_heads=5, n_kv_heads=5, d_ff=160,
                             vocab=129, n_layers=2, n_encoder_layers=2,
                             n_ctx_tokens=8)),
    # more rows than one attention chunk (1,024): the projections whole,
    # the weights' gradients on each rank's share; 1,031 frames pad to
    # two chunks
    "whisper-long": dict(arch="whisper-large-v3", mesh=(2, 2), batch=2,
                         seq=1040, cfg=dict(d_model=80, n_heads=5,
                                            n_kv_heads=5, d_ff=160,
                                            vocab=129, n_layers=1,
                                            n_encoder_layers=1,
                                            n_ctx_tokens=1031)),
    "vlm": dict(arch="llama-3.2-vision-11b", mesh=(2, 2), batch=2, seq=16,
                cfg=VLM,
                extras=dict(
                    # the self blocks' residual rows over ``model``, kept
                    # through the cross blocks (values only: the plan is
                    # not the reference's)
                    sp_residual_vlm=dict(
                        arch="llama-3.2-vision-11b", batch=2, seq=16,
                        cfg=VLM, env={"REPRO_SP_RESIDUAL": "1"}),
                    # Megatron-style residual rows over ``model``, GQA's
                    # K/V projected on each rank's rows
                    sp_residual_dense=dict(
                        arch="tinyllama-1.1b", batch=2, seq=16,
                        env={"REPRO_SP_RESIDUAL": "1"},
                        cfg=dict(d_model=64, n_heads=4, n_kv_heads=1,
                                 d_ff=128, vocab=128, n_layers=2)),
                    # arctic's shape: heads too few for the model axis
                    # (3 on 2) run whole on every rank, 4 experts split
                    no_sp_arctic=dict(
                        arch="arctic-480b", batch=2, seq=16,
                        env={"REPRO_NO_SP": "1"},
                        cfg=dict(d_model=48, n_heads=3, n_kv_heads=1,
                                 d_ff=64, vocab=128, n_layers=2,
                                 n_experts=4)))),
}
#: the extra models' runs, each in a case's process group: (case, extra)
EXTRAS = [(name, extra) for name, case in CASES.items()
          for extra in case.get("extras", {})]
#: the largest difference allowed (fp32, sums in another order): absolute
#: for the logits and the cache, relative to the largest gradient for the
#: gradients
TOL = dict(forward=2e-6, decode_logits=2e-6, decode_cache=2e-6, grad=2e-6)


#: the largest difference of a block's update (the mLSTM's, the
#: Mamba2's), relative to the plain update's largest value
#: (`_sharded_blocks.block_update`), and of each of its gradients,
#: relative to the plain gradient's largest value (`block_grad`)
UPDATE_TOL = 1e-5


def _updates(arch):
    """The runs of ``arch``'s cases whose first block's update is held:
    (case, extra or None)."""
    return [(name, extra) for name, case in CASES.items()
            if case["arch"] == arch
            for extra in (None, *case.get("extras", {}))]


#: xlstm's runs whose mLSTM update is held, and zamba2's whose Mamba2
#: update is
UPDATES = _updates("xlstm-1.3b")
MAMBA_UPDATES = _updates("zamba2-2.7b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's ranks, started together (one case at a time, so that
    at most 8 processes run at once); every rank's differences."""
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
               OMP_NUM_THREADS="1")
    out = {}
    for name, case in CASES.items():
        store = tmp_path_factory.mktemp(name)
        ps = [subprocess.Popen(
            [sys.executable, str(HERE / "_sharded_blocks.py"),
             json.dumps(case), str(r), str(store)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(math.prod(case["mesh"]))]
        try:
            # (a 1,040-row xlstm run: ~40 s alone, ~150 s or more beside
            # the test runner's other workers)
            res = [p.communicate(timeout=600) for p in ps]
        finally:    # a rank that failed leaves the others waiting
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, (_, err) in zip(ps, res):
            assert p.returncode == 0, (name, err[-4000:])
        out[name] = [json.loads(o.splitlines()[-1]) for o, _ in res]
    return out


@pytest.mark.parametrize("phase", list(TOL))
@pytest.mark.parametrize("name", list(CASES))
def test_partitioned_blocks_equal_plain(runs, name, phase):
    """On every rank, the partitioned run's values (whole) equal the
    plain model's within `TOL`: the logits of a forward and of two
    decode steps, the cache after them, and every parameter's gradient."""
    for r, got in enumerate(runs[name]):
        assert got[phase] <= TOL[phase], (name, phase, r, got)


@pytest.mark.parametrize("phase", list(TOL))
@pytest.mark.parametrize("name,extra", EXTRAS)
def test_knob_blocks_equal_plain(runs, name, extra, phase):
    """The reference's A/B knobs on real meshes: a dense toy under
    ``REPRO_SP_RESIDUAL`` (the residual's rows split over ``model``, GQA's
    K/V projected on each rank's rows, `parallel.axes.gathered_out`) and
    arctic's shape under ``REPRO_NO_SP`` (heads whole on every model
    rank, every attention weight's shard moved to the model axis), each
    in the vision model's run, the vision model and zamba2 under
    ``REPRO_SP_RESIDUAL`` in their own runs, and xlstm under
    ``REPRO_NO_SP`` in its runs at 16 and 1,040 rows (the mLSTM on
    blocks of the value dims, `models.xlstm._mlstm_by_value`): on every
    rank the same values as the plain model's within `TOL`."""
    for r, got in enumerate(runs[name]):
        assert got[f"{extra}.{phase}"] <= TOL[phase], (name, extra, phase,
                                                       r, got)


@pytest.mark.parametrize("name,extra", UPDATES)
def test_mlstm_update_equals_plain(runs, name, extra):
    """xlstm's first mLSTM block alone on a random residual, partitioned
    (over one chunk, past it at 1,040 rows, and under ``REPRO_NO_SP`` on
    blocks of the value dims) against plain: its update within
    `UPDATE_TOL` of the plain update's largest value on every rank.  At
    init the block moves the logits too little for `TOL` to see its
    plan: a wrong rank's value share in the output projection changes
    the update by 1.5x its size and the logits by 2.7e-7."""
    _hold_update(runs, name, extra, "mlstm_update")


@pytest.mark.parametrize("name,extra", MAMBA_UPDATES)
def test_mamba_update_equals_plain(runs, name, extra):
    """zamba2's first Mamba2 block alone on a random residual, partitioned
    (its plan on the 2 x 2 mesh, and under ``REPRO_SP_RESIDUAL`` on the
    residual's rows split over ``model``: the in-projection on each
    rank's rows, C.B^T on each rank's chunks) against plain: its update
    within `UPDATE_TOL` of the plain update's largest value on every
    rank."""
    _hold_update(runs, name, extra, "mamba_update")


@pytest.mark.parametrize("name,extra", UPDATES)
def test_mlstm_grad_equals_plain(runs, name, extra):
    """xlstm's first mLSTM block's gradients (of each weight and of the
    residual) of a random weighting of its update, partitioned against
    plain, each within `UPDATE_TOL` of the plain gradient's largest value
    on every rank: the block's backward plan alone."""
    _hold_update(runs, name, extra, "mlstm_grad")


@pytest.mark.parametrize("name,extra", MAMBA_UPDATES)
def test_mamba_grad_equals_plain(runs, name, extra):
    """zamba2's first Mamba2 block's gradients as the mLSTM's: under
    ``REPRO_SP_RESIDUAL`` the backward of C.B^T on each rank's chunks
    (its gradient's partial sums reduced, B's and C's on the rank's
    rows) and of the in-projection's all-to-all (each rank's rows'
    gradients sent back to their columns).  A mutant that skips that
    reduction, or reads another rank's chunks of the gradient or of B,
    or puts the all-to-all's gradients in other ranks' rows or other
    columns, fails it (1.9e-4 to 1.9)."""
    _hold_update(runs, name, extra, "mamba_grad")


def _hold_update(runs, name, extra, what):
    key = what if extra is None else f"{extra}.{what}"
    for r, got in enumerate(runs[name]):
        assert got[key] <= UPDATE_TOL, (name, extra, r, got[key])

"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the port (a Mess
point, a trace replay, the telemetry and command recorders through
``obs`` and ``oracle``, the LLM-serving lowering and its HLO cost model,
the figure and serving benches, one forward of every model family, two
compressed ``Trainer`` steps, the benchmark registry with every entry
resolved, a replay split over two devices) runs with ``jax`` blocked."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_runs_with_jax_blocked():
    code = """
import sys
sys.modules["jax"] = None            # any `import jax` now fails
import torch
from repro_torch.core import get_stage, run_point
out = run_point(get_stage("07-prefetch", windows=1, warmup=0), [2, 8], 16,
                device="cpu")
assert int(out["n_rd"].sum()) > 0
import repro_torch.bench.app_validation
import repro_torch.bench.cmd_oracle
import repro_torch.bench.perspectives
import repro_torch.bench.fig2_baseline
import repro_torch.bench.fig3_fig4_clocking
import repro_torch.bench.fig5_model_correct
import repro_torch.bench.fig6_enhancements
import repro_torch.bench.fig7_portability
import repro_torch.bench.serving
import repro_torch.bench.util
import repro_torch.bench.weave_bench
import repro_torch.perfmodel.hlo
from repro_torch.perfmodel.hlo_cost import analyze
from repro_torch.configs.registry import get_config
from repro_torch.traces import ServeScenario, decode_hlo, lower_scenario
assert analyze(decode_hlo(get_config("zamba2-2.7b"), 2, 16))["bytes"] > 0
tr, sched, info = lower_scenario(ServeScenario(get_config("arctic-480b")))
assert int(tr.length) == info["accesses"] > 0
import repro_torch.obs
import repro_torch.oracle
from repro_torch.traces import make_suite, replay_suite, stack_traces
rep = replay_suite(get_stage("01-baseline", windows=1, warmup=0),
                   stack_traces(make_suite(n=64, names=("stream",))[1]),
                   device="cpu")
assert int(rep["injected"][0]) > 0
from repro_torch.obs import collect, summarize
from repro_torch.oracle import check_stream, extract_stream
rec_cfg = get_stage("07-prefetch", windows=2, warmup=0, telemetry=True,
                    cmd_trace=True)
views = run_point(rec_cfg, [8], 16, device="cpu")
assert summarize(collect(rec_cfg, views))["commands"]["cas_rd"] > 0
assert check_stream(extract_stream({k: v[0] for k, v in views.items()},
                                   rec_cfg.platform.dram)).ok
from repro_torch.configs.registry import get_smoke
from repro_torch.models.registry import get_model
cfg = get_smoke("tinyllama-1.1b")
api = get_model(cfg)
logits = api.forward(api.init(0, device="cpu"),
                     {"tokens": torch.zeros((1, 5), dtype=torch.long)})
assert logits.shape == (1, 5, cfg.vocab) and bool(logits.isfinite().all())
import repro_torch.models.mamba2
import repro_torch.models.moe
import repro_torch.models.vlm
import repro_torch.models.whisper
import repro_torch.models.xlstm
for arch in ("grok-1-314b", "xlstm-1.3b", "zamba2-2.7b",
             "llama-3.2-vision-11b", "whisper-large-v3"):
    cfg = get_smoke(arch)
    api = get_model(cfg)
    batch = {"tokens": torch.zeros((1, 5), dtype=torch.long)}
    if api.needs_ctx:
        batch["ctx"] = torch.ones((1, cfg.n_ctx_tokens, cfg.d_model))
    logits = api.forward(api.init(0, device="cpu"), batch)
    assert logits.shape == (1, 5, cfg.vocab), arch
    assert bool(logits.isfinite().all()), arch
import repro_torch.data
import repro_torch.launch.train
import repro_torch.parallel
import repro_torch.train
from repro_torch.data.synthetic import DataConfig, Stream
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
cfg = get_smoke("tinyllama-1.1b")
trainer = Trainer(get_model(cfg), AdamWConfig(warmup_steps=1),
                  TrainerConfig(total_steps=2, ckpt_every=0,
                                compress_grads=True),
                  device="cpu", log_fn=lambda s: None)
res = trainer.fit(Stream(DataConfig(vocab=cfg.vocab, seq_len=8,
                                    global_batch=2)))
assert res["final_step"] == 2 and all(l == l for l in res["losses"])
import repro_torch.bench.kernels_bench
import repro_torch.bench.registry
import repro_torch.bench.run
import repro_torch.core.shard
from repro_torch.bench.registry import BENCHMARKS
assert all(spec.main for spec in BENCHMARKS.values())
rep = replay_suite(get_stage("01-baseline", windows=1, warmup=0),
                   stack_traces(make_suite(n=64, names=("stream", "gups"))[1]),
                   device=[torch.device("cpu")] * 2)
assert rep["injected"].shape == (2,) and int(rep["injected"][1]) > 0
leaked = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
assert not leaked, leaked
print("ok")
"""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")

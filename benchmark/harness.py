"""One run of one cell: set-up, the measured window, the traced sub-window
and per-layer readers (``--trace 1``), then the comparison with the plain
reference that decides ``correct``.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; it names a
configuration (``benchmark/configs/<config>.json``, whose ``adapter`` names
``benchmark/adapters/<adapter>.py``) and a traffic mix
(``benchmark/traffic/<traffic>.json``, read by the one generator in
``traffic.py``; its ``mode`` is ``train`` or ``predict`` and its ``limits``
are the comparison's). Each per-layer metric is
``benchmark/metrics/<metric>.py``, whose ``read(ctx)`` returns a number or
None where it finds nothing to read. All are found by name: a new cell,
configuration, traffic mix or metric is new files and new entries.

Training cells: set-up builds one task module and one ``Trainer`` and drives
them through the window's own call, ``Trainer.train_step``, for three steps
on three distinct batches of the pool, which the reference then follows
(``compare.train_checks``); the window keeps stepping the same objects,
dispatched ahead with one synchronisation at its end. Serving cells: a
closed loop of one client, each request numpy observations handed to the
module's ``predict`` and its actions back on the host; a sample of the
window's requests, drawn from the seed, is served again by the reference
with the same generator seed.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import random
import sys
import time
from types import SimpleNamespace

import torch

from benchmark import compare
from benchmark import device_trace
from benchmark import traffic as T
from benchmark.reference.train import three_steps

__all__ = ["Bench", "run_cell", "init_weights", "FORBIDDEN", "forbidden_loaded"]

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pointcloudmatters_tpu")
CHECKED_STEPS = 3


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def import_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names under ``bench_dir``."""

    def __init__(self, root: str, bench_dir: str = BENCH_DIR):
        self.root, self.dir = root, bench_dir
        self.spec = _load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return _load_json(os.path.join(self.root, entry["file"]))

    def traffic(self, name: str) -> dict:
        return _load_json(os.path.join(self.dir, "traffic", name + ".json"))

    def adapter(self, cfg: dict):
        name = cfg["adapter"]
        return import_file(os.path.join(self.dir, "adapters", name + ".py"),
                           f"benchmark_adapter_{name}")

    def metrics_of(self, cell: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports: those
        listing it, and those without a list whose end-to-end metric it
        reports."""
        e2e = [m["name"] for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if kind == "end_to_end":
            return [m for m in self.spec["end_to_end"] if m["name"] in e2e]
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]

    def reader(self, metric: str):
        return import_file(os.path.join(self.dir, "metrics", metric + ".py"),
                           f"benchmark_metric_{metric.replace('.', '_')}")


@torch.no_grad()
def init_weights(model: torch.nn.Module, gen: torch.Generator) -> None:
    """The benchmark's own weights, drawn in one call on the generator's
    device: linear and convolution weights normal with std 1/sqrt(fan-in),
    biases 0, norm scales 1, other learned tensors (embeddings, the CLS
    token) standard normal; running means 0 and variances 1."""
    nn = torch.nn
    leaves = [(mod, name, p) for mod in model.modules()
              for name, p in mod.named_parameters(recurse=False)]
    flat = torch.randn(sum(p.numel() for *_, p in leaves), generator=gen, device=gen.device)
    off = 0
    for mod, name, p in leaves:
        draw = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
        if name == "bias":
            p.zero_()
        elif name == "scale" or (name == "weight" and isinstance(mod, (nn.LayerNorm,
                                                                         nn.GroupNorm))):
            p.fill_(1.0)
        elif name == "weight" and isinstance(mod, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
            fan_in = (p.shape[0] * p.shape[2] if isinstance(mod, nn.ConvTranspose1d)
                      else p[0].numel())
            p.copy_(draw * fan_in ** -0.5)
        else:
            p.copy_(draw)
    for name, b in model.named_buffers():
        if name.endswith(".mean"):
            b.zero_()
        elif name.endswith(".var"):
            b.fill_(1.0)


def log(t_start: float, msg: str) -> None:
    """A phase's time since the process started, on standard error."""
    print(f"[{time.time() - t_start:8.2f} s] {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _cast_fn(precision: str, control: bool = False):
    """The forward's cast of the f32 weights and batch: bf16 under
    ``bf16-mixed``; the control's values are rounded through float8 (e4m3)
    first, while the gradient reaches the f32 weights as from the bf16 cast
    (a float8 cast would round the gradient too, and flush most of it)."""
    if precision != "bf16-mixed":
        return lambda t: t
    if control:  # the values rounded through float8, the gradient passed on in bf16
        return lambda t: t.to(torch.bfloat16) + (
            t.to(torch.float8_e4m3fn).to(torch.bfloat16) - t.to(torch.bfloat16)).detach()
    return lambda t: t.to(torch.bfloat16)


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 products on (the f32 control) or off inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _setup_common(bench: Bench, cell: str, overrides: dict):
    """(configuration, traffic, adapter) of ``cell``, with the overrides."""
    w = bench.cell(cell)
    cfg = {**bench.config(w["config"]), **overrides.get("config", {})}
    tr = {**bench.traffic(w["traffic"]), **overrides.get("traffic", {})}
    return cfg, tr, bench.adapter(cfg)


def _program(bld, cfg, data, seed, device):
    policy = bld.make_policy(cfg, device)
    init_weights(policy, T.generator(seed, "weights", device))
    n = sum(p.numel() for p in policy.parameters())
    if cfg.get("parameters") and n != cfg["parameters"]:
        raise AssertionError(f"the policy has {n} parameters, the configuration "
                             f"{cfg['parameters']}")
    init = {name: _host(p) for name, p in policy.named_parameters()}
    buffers = {name: _host(b) for name, b in policy.named_buffers()}
    return bld.make_module(policy, cfg, data), init, buffers


def _reference_train(bld, cfg, tr, init, batches, extras, stream_seed, device, control=False):
    """The reference's three steps on ``batches`` (on the device)."""
    rngs = bld.ref_streams(stream_seed, device)
    loss_fn = lambda P, batch, r: bld.ref_loss(P, batch, cfg, r, extras)  # noqa: E731
    init_dev = {n: t.to(device) for n, t in init.items()}
    with _tf32(control and tr["precision"] != "bf16-mixed"):
        return three_steps(loss_fn, init_dev, batches, rngs, cfg["optimizer"],
                           cfg["lr_scheduler"], tr["total_steps"],
                           _cast_fn(tr["precision"], control))


def run_train(bench, cell, seed, seconds, trace, device, t_start, overrides, hooks):
    cfg, tr, bld = _setup_common(bench, cell, overrides)
    from pointcloudmatters_tpu_torch.trainer import Trainer

    log(t_start, "imports done")
    pool, data = bld.make_pool(cfg, tr, T.generator(seed, "data", device))
    _sync(device)
    log(t_start, f"{len(pool)} batches made")
    module, init, _ = _program(bld, cfg, data, seed, device)
    _sync(device)
    log(t_start, "policy built and weights drawn")
    stream_seed = T.derive_seed(seed, "streams") % 2**31
    trainer = Trainer(precision=tr["precision"], seed=stream_seed,
                      accelerator="cpu" if torch.device(device).type == "cpu" else "gpu")
    trainer.setup(module, tr["total_steps"])
    hooks.get("program", lambda m, t: None)(module, trainer)
    named = list(module.policy.named_parameters())
    beta1 = module.optimizer.param_groups[0]["betas"][0]
    losses, grads = [], None
    for i in range(CHECKED_STEPS):
        losses.append(trainer.train_step(module, pool[i])["loss"])
        _sync(device)
        log(t_start, f"checked step {i + 1}")
        if i == 0:  # the first gradient as AdamW got it: m_1 = (1 - beta1) g
            state = module.optimizer.state
            grads = {n: _host(state[p]["exp_avg"] / (1.0 - beta1)) if "exp_avg" in state[p]
                     else torch.zeros(p.shape) for n, p in named}
    after = {n: _host(p) for n, p in named}
    losses = [float(x) for x in losses]
    # a step on each batch shape the checked steps did not meet
    shape = lambda b: bld.clouds(b)["valid"].shape[-1]  # noqa: E731
    seen = {shape(b) for b in pool[:CHECKED_STEPS]}
    for b in pool[CHECKED_STEPS:]:
        if shape(b) not in seen:
            seen.add(shape(b))
            trainer.train_step(module, b)
            log(t_start, f"warm-up step on {shape(b)} slots")
    _sync(device)
    setup_s = time.time() - t_start
    log(t_start, f"{CHECKED_STEPS} checked steps; set-up done")

    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    step_losses = []
    t0 = time.perf_counter()
    while True:
        step_losses.append(trainer.train_step(module, pool[(CHECKED_STEPS + len(step_losses))
                                                            % len(pool)])["loss"])
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    steps = len(step_losses)
    log(t_start, f"window: {steps} steps in {window_s:.3f} s")
    failed = int((~torch.isfinite(torch.stack(step_losses).float())).sum())
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    ctx = SimpleNamespace(mode="train", cfg=cfg, traffic=tr, device=device, module=module,
                          trainer=trainer, adapter=bld, window_s=window_s, units=steps,
                          batch_size=tr["batch_size"], sample=pool[0],
                          flops=bld.step_flops(cfg, tr, pool), peak_window_bytes=window_peak,
                          trace=None)
    if trace:
        def run_traced(n=tr["trace_steps"]):
            for i in range(n):
                trainer.train_step(module, pool[i % len(pool)])
            return n
        ctx.trace = device_trace.traced(run_traced, lambda: run_traced(1))
    per_layer = _read_metrics(bench, cell, ctx) if trace else {}
    if trace:
        log(t_start, f"traced and read: {per_layer}")
    e2e = {"train_samples_per_s": steps * tr["batch_size"] / window_s, "setup_s": setup_s}

    checked, summary = pool[:CHECKED_STEPS], ctx.trace
    del ctx, module, trainer, pool, step_losses, named
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    extras = bld.ref_extras(cfg, data)
    ref = _reference_train(bld, cfg, tr, init, checked, extras, stream_seed, device)
    prog = {"losses": losses, "grads": grads, "deltas": {n: after[n] - init[n] for n in init}}
    if hooks.get("control"):  # the reference one precision down in the program's place
        prog = _reference_train(bld, cfg, tr, init, checked, extras, stream_seed, device,
                                control=True)
    where: dict = {}
    checks = compare.train_checks(prog, ref, device, where)
    log(t_start, f"reference done; losses {losses} against {ref['losses']}; worst leaves {where}")
    return dict(attempted=steps, failed=failed, e2e=e2e, per_layer=per_layer, checks=checks,
                memory_peak_bytes=max(setup_peak, window_peak), limits=tr["limits"],
                summary=summary)


def run_predict(bench, cell, seed, seconds, trace, device, t_start, overrides, hooks):
    cfg, tr, bld = _setup_common(bench, cell, overrides)
    log(t_start, "imports done")
    requests, data = bld.make_requests(cfg, tr, T.generator(seed, "data", device))
    log(t_start, f"{len(requests)} requests made")
    module, init, buffers = _program(bld, cfg, data, seed, device)
    _sync(device)
    log(t_start, "policy built and weights drawn")
    hooks.get("program", lambda m, t: None)(module, None)
    serve = hooks.get("predict", bld.predict)
    if hooks.get("control"):  # the reference one precision down in the program's place
        serve = _control_server(bld, cfg, init, buffers, data, device)
    gen_seeds = [T.derive_seed(seed, f"request {i}") for i in range(tr["pool"])]
    new_gen = lambda s: torch.Generator(device=device).manual_seed(s)  # noqa: E731
    warm: dict = {}  # a warm-up request of each shape the pool holds: the last of it
    for i in reversed(range(len(requests))):
        warm.setdefault(bld.clouds(requests[i])["valid"].shape[-1], i)
    for i in sorted(warm.values()):
        serve(module, requests[i], new_gen(gen_seeds[i]))
    _sync(device)
    setup_s = time.time() - t_start
    log(t_start, f"{len(warm)} warm-up requests ({sorted(warm)} slots); set-up done")

    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    answers = []
    t0 = time.perf_counter()
    while True:
        i = len(answers) % len(requests)
        answers.append(serve(module, requests[i], new_gen(gen_seeds[i])))
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    n = len(answers)
    log(t_start, f"window: {n} requests in {window_s:.3f} s")
    want = answers[0].shape
    failed = sum(1 for a in answers if a.shape != want or not bool(torch.isfinite(
        torch.as_tensor(a)).all()))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    ctx = SimpleNamespace(mode="predict", cfg=cfg, traffic=tr, device=device, module=module,
                          adapter=bld, window_s=window_s, units=n,
                          batch_size=tr["batch_size"], sample=requests[0],
                          flops=bld.request_flops(cfg, tr, requests), peak_window_bytes=peak,
                          trace=None)
    if trace:
        def run_traced(n=tr["trace_requests"]):
            for i in range(n):
                serve(module, requests[i], new_gen(gen_seeds[i]))
            return n
        ctx.trace = device_trace.traced(run_traced, lambda: run_traced(1))
    per_layer = _read_metrics(bench, cell, ctx) if trace else {}
    if trace:
        log(t_start, f"traced and read: {per_layer}")
    e2e = {"predict_ms": window_s * 1e3 / n, "setup_s": setup_s}
    summary = ctx.trace
    del ctx, module
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference over a sample of the window's requests, drawn from the seed
    picks = random.Random(T.derive_seed(seed, "sample")).sample(
        range(min(n, len(requests))), min(tr["checked_requests"], n, len(requests)))
    extras = bld.ref_extras(cfg, data)
    P = {k: v.to(device) for k, v in init.items()}
    B = {k: v.to(device) for k, v in buffers.items()}
    gap = 0.0
    for i in picks:
        ref = bld.ref_predict(P, B, _to_device(requests[i], device), cfg, extras,
                              new_gen(gen_seeds[i]))
        gap = max(gap, compare.action_gap(torch.as_tensor(answers[i]), ref))
    log(t_start, f"reference done over requests {picks}")
    return dict(attempted=n, failed=failed, e2e=e2e, per_layer=per_layer,
                checks={"action_gap": gap}, memory_peak_bytes=max(setup_peak, peak),
                limits=tr["limits"], summary=summary)


def _control_server(bld, cfg, init, buffers, data, device):
    """``predict(module, obs, generator)`` served by the reference with TF32
    products, on the benchmark's weights (the module is not used)."""
    extras = bld.ref_extras(cfg, data)
    P = {k: v.to(device) for k, v in init.items()}
    B = {k: v.to(device) for k, v in buffers.items()}

    def serve(module, obs, gen):
        with _tf32(True):
            return bld.ref_predict(P, B, _to_device(obs, device), cfg, extras, gen).cpu().numpy()
    return serve


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def _read_metrics(bench: Bench, cell: str, ctx) -> dict:
    out = {}
    for m in bench.metrics_of(cell, "per_layer"):
        value = bench.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _half(tree):
    """Every tensor of a nested dict cut to the first half of its rows."""
    if isinstance(tree, dict):
        return {k: _half(v) for k, v in tree.items()}
    return tree[:max(1, tree.shape[0] // 2)]


def reference_pair(root: str, cell: str, seed: int, device, variant: str,
                   overrides: dict | None = None, bench_dir: str = BENCH_DIR,
                   where: dict | None = None) -> dict:
    """The numbers compared when the reference itself stands in the
    program's place, changed by ``variant``: ``"control"`` (one precision
    below the configuration's: float8 casts under bf16-mixed, TF32 products
    under f32) or ``"half_batch"`` (training: each step on the first half of
    its batch's rows, the mean over them); against the reference as the
    cell runs it, on the cell's inputs and weights from ``seed``."""
    bench = Bench(root, bench_dir)
    cfg, tr, bld = _setup_common(bench, cell, overrides or {})
    gen = T.generator(seed, "data", device)
    pool, data = (bld.make_pool if tr["mode"] == "train" else bld.make_requests)(cfg, tr, gen)
    policy = bld.make_policy(cfg, device)
    init_weights(policy, T.generator(seed, "weights", device))
    init = {n: p.detach().clone() for n, p in policy.named_parameters()}
    buffers = {n: b.detach().clone() for n, b in policy.named_buffers()}
    del policy
    extras = bld.ref_extras(cfg, data)
    if tr["mode"] == "train":
        stream_seed = T.derive_seed(seed, "streams") % 2**31
        batches = pool[:CHECKED_STEPS]
        ref = _reference_train(bld, cfg, tr, init, batches, extras, stream_seed, device)
        if variant == "half_batch":
            batches = [_half(b) for b in batches]
        alt = _reference_train(bld, cfg, tr, init, batches, extras, stream_seed, device,
                               control=variant == "control")
        return compare.train_checks(alt, ref, device, where)
    if variant != "control":
        raise ValueError(f"a serving cell has no {variant!r} fault")
    gen_seeds = [T.derive_seed(seed, f"request {i}") for i in range(tr["pool"])]
    gap = 0.0
    for i in range(tr["checked_requests"]):
        obs = _to_device(pool[i], device)

        def serve():
            gen = torch.Generator(device=device).manual_seed(gen_seeds[i])
            return bld.ref_predict(init, buffers, obs, cfg, extras, gen)

        ref = serve()
        with _tf32(True):
            alt = serve()
        gap = max(gap, compare.action_gap(alt, ref))
    return {"action_gap": gap}


def run_cell(root: str, cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: dict | None = None, hooks: dict | None = None,
             bench_dir: str = BENCH_DIR) -> dict:
    """One run of ``cell`` on ``device`` -> the result line's dict (without
    ``device``'s card fields) and ``"checks"``: each number compared with
    its limit. ``overrides`` replace keys of the configuration and of the
    traffic (the tests' tiny sizes); ``hooks`` replace the program's pieces
    (the tests' faults): ``program(module, trainer)`` after set-up,
    ``predict(module, obs, generator)`` for each request; ``control: True``
    puts the control, the reference one precision below the configuration's,
    in the program's place for what is compared."""
    bench = Bench(root, bench_dir)
    log(t_start, "harness imported")
    mode = bench.traffic(bench.cell(cell)["traffic"])["mode"]
    run = {"train": run_train, "predict": run_predict}[mode]
    out = run(bench, cell, seed, seconds, trace, device, t_start, overrides or {}, hooks or {})
    e2e = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
           for m in bench.metrics_of(cell, "end_to_end")}
    # the numbers the cell compares are those its traffic gives a limit
    checks = {k: {"value": v, "limit": out["limits"][k]} for k, v in out["checks"].items()
              if k in out["limits"]}
    unlimited = {k: v for k, v in out["checks"].items() if k not in out["limits"]}
    if unlimited:
        log(t_start, f"read, not compared: {unlimited}")
    correct = (out["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["per_layer"] if trace else e2e,
              "device": {"memory_peak_bytes": int(out["memory_peak_bytes"])}}
    summary = out["summary"]
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result

"""One run of one benchmark cell: set-up, the measured window, the traced
slice, the output check, the result line.

A cell names a configuration file, a traffic mix and its limits; its
end-to-end metrics are taken here on the host clock, its per-layer metrics
by the readers in ``metrics/`` from what this module observes between engine
steps and from the profiler's trace of a slice of the window. Nothing here
is specific to one cell."""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from perfbench import loadgen, stats
from perfbench import roofline as RL
from perfbench import weights as W

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
KERNEL_LIBS = ("consmax_decode", "consmax_prefill", "graph_cond")
SLICE_SECONDS = 0.5      # traced slice: at least this long ...
SLICE_STEPS = 4          # ... and this many engine steps
SAMPLE_TOKENS = 2048     # the output check compares at least this many
SAMPLE_REQUESTS = 8      # ... served tokens and this many finished
SAMPLE_MAX_REQUESTS = 64  # ... requests, from at most this many
TOP = 10                 # entries of each breakdown list


# ------------------------------------------------------------- the cell ----
@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    end_to_end: list             # BENCHMARK.json metric entries
    per_layer: list
    limits: dict                 # {check: {"limit": x, ...}}
    chips: int = 1


def _read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files."""
    spec = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"expected one of {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name=name, config=_read_json(root / conf["file"]),
                mix=_read_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)],
                limits=_read_json(HERE / "limits" / f"{name}.json"),
                chips=w["chips"])


def reader(metric: str):
    """The ``read(ctx)`` function of per-layer metric ``metric``
    (``metrics/<metric>.py``)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


# ------------------------------------------------------- the port's side ----
def port_configs(cfg: dict):
    """(ModelConfig, ServeConfig) of the port for configuration file
    ``cfg``."""
    from repro_torch.configs.base import (ConSmaxConfig, ModelConfig,
                                          ServeConfig)
    if cfg["family"] != "dense":
        raise NotImplementedError(f"family {cfg['family']!r}")
    # what the port's dense decoder fixes: a file that states otherwise
    # lists the key in ``reduced`` and sets it to the port's value
    fixed = dict(rms_norm_eps=1e-6, tie_word_embeddings=True,
                 hidden_act="silu", rope_scaling=None)
    for key, want in fixed.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"{cfg['name']}: {key}={cfg[key]!r}; the port "
                             f"serves {want!r}")
    port, m = cfg["port"], W.dims(cfg)
    mcfg = ModelConfig(
        arch_id=cfg["name"], family="dense", n_layers=m["layers"],
        d_model=m["d"], n_heads=m["H"], n_kv_heads=m["hkv"], d_ff=m["ff"],
        vocab_size=m["vocab"], head_dim=cfg.get("head_dim", 0),
        score_norm=port["score_norm"],
        consmax=ConSmaxConfig(**port["consmax"]), qkv_bias=m["qkv_bias"],
        rope_theta=float(cfg["rope_theta"]),
        param_dtype=port["param_dtype"], compute_dtype=port["compute_dtype"])
    return mcfg, ServeConfig(score_norm=port["score_norm"],
                             **cfg["serving"])


def load_model(cfg: dict, mcfg, seed: int, device):
    """The port's ``LM`` in its served dtype, its weights the harness's
    (``weights.make``) loaded through its parameter names."""
    from repro_torch.models import transformer as T
    lm = T.cast_param_dtype(T.LM(mcfg, device=device), mcfg)
    names = {n for n, _ in lm.named_parameters()}
    loaded = set()
    for group in W.groups(cfg):
        state = W.make(cfg, seed, group, device)
        missing, unexpected = lm.load_state_dict(state, strict=False)
        if unexpected:
            raise KeyError(f"weights the port does not have: {unexpected}")
        loaded |= set(state)
        del state
    if loaded != names:
        raise KeyError(f"port parameters left unloaded: "
                       f"{sorted(names - loaded)}")
    return lm


# ------------------------------------------------------ the closed loop ----
@dataclass
class Flight:
    client: int
    req: loadgen.Request
    uid: int
    t_send: float
    filled: int = 0
    ntok: int = 0
    t_last: float = 0.0
    tokens: list | None = None       # served tokens, once finished


@dataclass
class Work:
    """What the engine served over some steps, as observed between them.
    ``chunks`` and ``decode_keys`` (the lengths the roofline and FLOP
    reckoning need) are kept for the traced slice only."""
    steps: int = 0
    tokens: int = 0                  # tokens delivered
    first_tokens: int = 0
    decode_rows: int = 0
    chunks: list | None = None       # (start, n)
    decode_keys: list | None = None  # keys each decode row saw

    def model_work(self) -> dict:
        """Tokens, (query, key) pairs and sampled positions for the model
        FLOP reckoning: every chunk row and decode row is a token; every
        chunk samples its last row's logits, as every decode row does."""
        pairs = (sum(RL.chunk_pairs(s, n) for s, n in self.chunks)
                 + sum(self.decode_keys))
        return dict(tokens=sum(n for _, n in self.chunks)
                    + len(self.decode_keys), pairs=pairs,
                    sampled=len(self.chunks) + len(self.decode_keys))


def detailed() -> Work:
    return Work(chunks=[], decode_keys=[])


class ClosedLoop:
    """``clients`` callers in front of the engine, each sending its next
    request as soon as its previous reply has ended."""

    def __init__(self, eng, traffic: loadgen.Traffic, clock):
        self.eng, self.traffic, self.clock = eng, traffic, clock
        self.flights: dict[int, Flight] = {}        # uid -> in flight
        self.free = list(range(traffic.clients))
        self.finished: list[Flight] = []            # finished in window
        self.in_window = False
        self.attempted = self.failed = 0
        self.ttft: list[float] = []
        self.itl: list[float] = []
        self.window = Work()
        self.slice: Work | None = None

    def send(self):
        while self.free:
            client = self.free.pop(0)
            req = self.traffic.take()
            t = self.clock()
            if self.in_window:
                self.attempted += 1
            try:
                uid = self.eng.submit(req.prompt, req.max_new_tokens)
            except ValueError:
                self.failed += 1
                self.free.append(client)
                continue
            self.flights[uid] = Flight(client, req, uid, t)

    def observe(self, t: float):
        """Read what the step that just ended delivered, at time ``t``."""
        eng = self.eng
        live = {s.request.uid: s for s in eng.scheduler.slots
                if s is not None}
        win = self.window if self.in_window else None
        sl = self.slice
        for w in (win, sl):
            if w is not None:
                w.steps += 1
        for uid, f in list(self.flights.items()):
            st = live.get(uid)
            if st is not None:
                filled, ntok = st.filled, len(st.generated)
                done = False
            elif uid in eng.results:
                filled, ntok = len(f.req.prompt), len(eng.results[uid])
                done = True
            else:
                continue                                  # still queued
            new = ntok - f.ntok
            first = int(f.ntok == 0 and new > 0)
            for w in (win, sl):
                if w is not None:
                    w.tokens += new
                    w.first_tokens += first
                    w.decode_rows += new - first
            if sl is not None:
                if filled > f.filled:
                    sl.chunks.append((f.filled, filled - f.filled))
                n_prompt = len(f.req.prompt)
                sl.decode_keys.extend(range(n_prompt + f.ntok + first,
                                            n_prompt + ntok))
            if new > 0:
                if win is not None:
                    if first:
                        self.ttft.append(t - f.t_send)
                    else:
                        self.itl.append(t - f.t_last)
                    if new > 1:
                        self.itl.extend([0.0] * (new - 1))  # delivered
                        #                                    together
                f.t_last = t
            f.filled, f.ntok = filled, ntok
            if done:
                del self.flights[uid]
                self.free.append(f.client)
                tokens = eng.results.pop(uid)
                if win is not None:
                    f.tokens = tokens
                    self.finished.append(f)

    def warm(self):
        """Set-up: every client's first request admitted and prefilled (a
        steady-state start) and both graphs captured."""
        self.send()
        first = set(self.flights)
        while True:
            self.eng.step()
            self.observe(self.clock())
            self.send()
            waiting = [u for u in first if u in self.flights
                       and self.flights[u].ntok == 0]
            if not waiting and (not self.eng.graphed or (
                    self.eng.prefill_graphs and self.eng.decode_graphs)):
                return


# ----------------------------------------------------------- the trace ----
def _trace_events(prof):
    """(device intervals [(start_s, end_s, name)], host events [(start_s,
    end_s, name)]) of a finished profile, from its Kineto records. The host
    ranges' mirrors on the device timeline (user annotations) are not
    device work and are left out."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns())
                * 1e-9, e.name())
        if e.device_type() != DeviceType.CUDA:
            host.append(item)
        elif not (e.is_user_annotation() or e.name().startswith(
                "perfbench.")):
            dev.append(item)
    return dev, host


def read_slice(prof, marker: str) -> dict:
    """Device busy seconds, seconds by kernel name and idle seconds by what
    the host was doing, over the slice the ``marker`` range spans."""
    dev, host = _trace_events(prof)
    spans = [(s, e) for s, e, n in host if n == marker]
    if not spans:
        raise RuntimeError(f"the trace has no {marker!r} range")
    t0, t1 = spans[0]
    dev = [(max(s, t0), min(e, t1), n) for s, e, n in dev
           if e > t0 and s < t1]
    by_kernel: dict[str, float] = {}
    for s, e, n in dev:
        by_kernel[n] = by_kernel.get(n, 0.0) + (e - s)
    gaps = RL.idle_gaps([(s, e) for s, e, _ in dev], t0, t1)
    inner = sorted(((s, e, n) for s, e, n in host
                    if n != marker and s < t1 and e > t0),
                   key=lambda x: x[1] - x[0])
    by_host: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        what = next((n for s, e, n in inner if s <= mid <= e), "host")
        by_host[what] = by_host.get(what, 0.0) + (b - a)
    return dict(seconds=t1 - t0,
                busy_s=RL.busy_union([(s, e) for s, e, _ in dev]),
                kernel_s=by_kernel, idle_by_host=by_host)


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def breakdown(sl: dict) -> dict:
    ops = sorted(sl["kernel_s"].items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(sl["idle_by_host"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[_short(n), s] for n, s in ops],
            "idle_gaps": [[_short(n), s] for n, s in gaps]}


# ------------------------------------------------------ the output check ----
def sample(finished: list[Flight], seed: int) -> list[Flight]:
    """The finished requests the check compares, drawn from the seed: the
    one with the most served tokens, then others until ``SAMPLE_TOKENS``
    served tokens and ``SAMPLE_REQUESTS`` requests are reached (at most
    ``SAMPLE_MAX_REQUESTS``), or the finished requests run out."""
    if not finished:
        return []
    longest = max(finished, key=lambda f: (len(f.tokens), -f.req.index))
    rest = [f for f in finished if f is not longest]
    order = np.random.default_rng([seed & loadgen._MASK, 2]).permutation(
        len(rest))
    out, n = [longest], len(longest.tokens)
    for i in order:
        if len(out) >= SAMPLE_MAX_REQUESTS or (
                n >= SAMPLE_TOKENS and len(out) >= SAMPLE_REQUESTS):
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


# The numbers the output check can compare, from the gaps at every served
# position of the sample (each the gap by which the served token's logit
# lies below the reference's best; 0 where the served token is the
# reference's first). A cell compares those its limits file names.
GAP_STATS = {
    # the widest gap: a near-tie decided the wrong way by more than the
    # served precision explains
    "max_logit_gap": lambda g: float(g.max()),
    # the mean gap: how often and by how much served tokens depart from
    # the reference's first, over the whole sample (it grows with the
    # square of the served logits' error)
    "mean_logit_gap": lambda g: float(g.mean()),
}


def check_outputs(cell: Cell, seed: int, loop: ClosedLoop, device, *,
                  chooser: str | None = None) -> tuple[dict, dict]:
    """(the sample's numbers, ``{check: {"value", "limit"}}``). The gaps
    by which the served tokens' logits lie below the plain reference's best,
    over a sample of the requests finished in the window, give every number
    of ``GAP_STATS``; those the cell's limits file names are compared, and
    so is the count of finished requests whose reply is not as long as
    asked (limit 0)."""
    fam = cell.config["family"]
    ref = importlib.import_module(f"perfbench.reference.{fam}")
    picked = sample(loop.finished, seed)
    seqs = [(f.req.prompt + f.tokens, len(f.req.prompt)) for f in picked]
    gaps = (ref.logit_gaps(cell.config, seed, seqs, device, chooser=chooser)
            if seqs else [])
    flat = np.concatenate(gaps) if gaps else np.zeros(0)
    numbers = {k: (f(flat) if len(flat) else None)
               for k, f in GAP_STATS.items()}
    found = dict(numbers, compared_tokens=int(len(flat)),
                 not_reference_first=int((flat > 0).sum()),
                 compared_requests=len(picked),
                 reference_tokens=int(sum(len(t) for t, _ in seqs)),
                 finished_requests=len(loop.finished))
    unknown = set(cell.limits) - set(GAP_STATS)
    if unknown:
        raise KeyError(f"{cell.name}: limits for unknown numbers "
                       f"{sorted(unknown)}; known: {sorted(GAP_STATS)}")
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]["limit"]}
              for k in GAP_STATS if k in cell.limits}
    short = sum(len(f.tokens) != f.req.max_new_tokens for f in loop.finished)
    checks["short_replies"] = {"value": short, "limit": 0}
    return found, checks


# ------------------------------------------------------------- the run ----
def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


CONTROLS = ("fp8-kv", "fp8-operands")


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: str | None = None) -> dict:
    """Serve ``cell`` for ``seconds`` on ``device`` and return the result
    (the contract's last line, as a dict; ``checks`` last). ``control``
    makes it no benchmark run: ``"fp8-operands"`` (the output check's
    control) judges, in place of the served tokens, the tokens the
    reference picks with every product on fp8 operands; ``"fp8-kv"`` serves
    with the port's own fp8_e4m3 KV cache in place of the configured
    precision, to read what the check makes of that path."""
    if control not in (None,) + CONTROLS:
        raise ValueError(f"unknown control {control!r}; one of {CONTROLS}")
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.serve.engine import ContinuousBatchingEngine

    clock = time.perf_counter
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        from repro_torch.kernels import _build
        _build.build(KERNEL_LIBS)
        torch.cuda.reset_peak_memory_stats(device)
    config = cell.config
    if control == "fp8-kv":
        config = dict(config, serving=dict(config["serving"],
                                           kv_cache_dtype="fp8_e4m3"))
    mcfg, scfg = port_configs(config)
    lm = load_model(cell.config, mcfg, seed, device)
    eng = ContinuousBatchingEngine(mcfg, scfg, lm, device=device)
    traffic = loadgen.Traffic(cell.mix, mcfg.vocab_size, seed)
    loop = ClosedLoop(eng, traffic, clock)
    loop.warm()
    if cuda:
        torch.cuda.synchronize(device)

    # ---- the window
    loop.in_window = True
    t0 = clock()
    setup_s = t0 - t_start
    it0, rep0 = eng.iterations, eng.graph_replays
    prof = marker = traced = None      # the profile; the slice's work
    half = t0 + seconds / 2
    while True:
        if trace and traced is None and prof is None and clock() >= half:
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if cuda else []))
            prof.__enter__()
            marker = record_function("perfbench.slice")
            marker.__enter__()
            loop.slice, t_sl = detailed(), clock()
        with record_function("perfbench.submit"):
            loop.send()
        with record_function("perfbench.step"):
            eng.step()
        t = clock()
        with record_function("perfbench.observe"):
            loop.observe(t)
        if loop.slice is not None and (loop.slice.steps >= SLICE_STEPS
                                       and t - t_sl >= SLICE_SECONDS):
            if cuda:
                torch.cuda.synchronize(device)
            marker.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            traced, loop.slice = loop.slice, None
        if t >= t0 + seconds:
            break
    window_s = t - t0
    if loop.slice is not None:          # the window closed inside the slice
        if cuda:
            torch.cuda.synchronize(device)
        marker.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        traced, loop.slice = loop.slice, None
    iterations = eng.iterations - it0
    replays = eng.graph_replays - rep0
    peak = (torch.cuda.max_memory_allocated(device) if cuda else 0)
    # the trace is read once the window has closed
    sl = None if traced is None else read_slice(prof, "perfbench.slice")

    # ---- metrics
    w = loop.window
    e2e = {
        "gen_tok_s": (stats.rate(w.tokens, window_s), "tokens/s"),
        "ttft_p95_ms": (_ms(stats.percentile(loop.ttft, 95)), "ms"),
        "itl_p95_ms": (_ms(stats.percentile(loop.itl, 95)), "ms"),
        "setup_s": (setup_s, "s"),
    }
    ctx = dict(
        dims=W.dims(cell.config),
        kv_bytes=1 if scfg.kv_cache_dtype in ("int8", "fp8_e4m3") else 2,
        window=dict(seconds=window_s, iterations=iterations,
                    tokens=w.tokens, first_tokens=w.first_tokens,
                    decode_rows=w.decode_rows, graph_replays=replays),
        slice=None if sl is None else dict(sl, work=traced),
        memory=dict(max_allocated=peak))
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v, unit = e2e[m["name"]]
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": unit}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace and sl is not None:
        dev["busy_s"], dev["window_s"] = sl["busy_s"], sl["seconds"]
    if cuda:
        dev["power"] = _power_limit()

    # ---- the output check, once the program's state is freed
    del eng, lm
    loop.eng = None
    gc.collect()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    t_check = clock()
    found, checks = check_outputs(
        cell, seed, loop, device,
        chooser="fp8" if control == "fp8-operands" else None)
    check_s = clock() - t_check
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": bool(correct), "attempted": loop.attempted,
              "failed": loop.failed, "metrics": metrics, "device": dev}
    if trace and sl is not None:
        result["breakdown"] = breakdown(sl)
    result["check_s"] = check_s
    result["sample"] = found
    result["checks"] = checks
    return result


def _ms(seconds):
    return None if seconds is None else 1e3 * seconds

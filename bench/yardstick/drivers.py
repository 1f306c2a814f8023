"""One run of a cell: set-up, the measured window, the traced window, the
comparison with the plain reference.  The program (``repro_torch``) is
imported here, inside the functions that drive it, and only its system
under test is taken from it: the model, the train step and its AdamW, the
serving engine, the kernels' launch counters and their libraries' build.

Order of a run: build the program's object from the benchmark's weights
and warm it up (for training: the first ``check_steps`` steps, read for
the check); the window (tracing off); with ``--trace 1`` a few more steps
or batches under the profiler; the peak memory is read; the program's
state is freed; the reference runs; the numbers are judged.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from yardstick import compare, plain, traffic, weights
from yardstick import trace as trace_lib


@dataclasses.dataclass
class Record:
    """What the readers of the per-layer metrics read."""
    kind: str                       # "train" | "score"
    model: dict
    spec: dict
    window_s: float
    step_s: list[float]             # train: each window step, host clock
    prefill_s: list[float]          # score: Engine.timing["prefill_s"]
    lengths: list[list[int]]        # score: each window batch's prompts
    trace: trace_lib.Trace | None = None
    traced: list[dict] = dataclasses.field(default_factory=list)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict[str, int]:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms

    return {"flash_fwd": fa.flash_attention_gqa.launches,
            "flash_bwd": fa.flash_attention_bwd.launches,
            "mamba2_scan": ms.mamba2_scan.launches,
            "mamba2_scan_bwd": ms.mamba2_scan_bwd.launches}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def _load_kernels(m: dict, train: bool, dev: torch.device) -> None:
    """Build (first run in a checkout) or load the kernel libraries the
    cell runs, together, before anything is timed."""
    if dev.type != "cuda":
        return
    from repro_torch.kernels import _build

    names = ["flash_attention"] + (["flash_attention_bwd"] if train else []) \
        + (["mamba_scan"] if m["family"] == "hybrid" else [])
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load, names))


def _profiled(fn, dev: torch.device) -> trace_lib.Trace:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace_lib.WINDOW_SPAN):
            fn()
            _sync(dev)
    return trace_lib.from_profiler(prof)


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _norm_change(p: torch.Tensor, p0: torch.Tensor) -> float:
    """||p - p0|| in float32, a leading slice at a time."""
    if p.dim() == 0:
        return float((p.float() - p0.float()).abs())
    total = 0.0
    for a, b in zip(p, p0):
        total += float((a.float() - b.float()).square().sum())
    return total ** 0.5


GRAD_SAMPLE = 1 << 20    # elements of a leaf compared one by one


def grad_index(lf: weights.Leaf, seed: int, index: int,
               dev: torch.device) -> torch.Tensor:
    """The flat indices of leaf ``index`` at which the first gradient is
    compared element by element: every element of a small leaf, else
    ``GRAD_SAMPLE`` drawn from the seed."""
    n = math.prod(lf.shape)
    if n <= GRAD_SAMPLE:
        return torch.arange(n, device=dev)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 6, index]))
    return torch.as_tensor(rng.integers(0, n, GRAD_SAMPLE), device=dev)


def schedule(opt: dict, step: int) -> float:
    """The learning rate at ``step``: linear warm-up, then cosine decay to
    ``min_lr_ratio`` (``optim/adamw.py``'s schedule, by its equations)."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * t))
    return opt["lr"] * warm * (opt["min_lr_ratio"]
                               + (1 - opt["min_lr_ratio"]) * cos)


# --- training ---------------------------------------------------------------

class TrainRun:
    """The program's train step, its state and its feed."""

    def __init__(self, cell, seed: int, dev: torch.device):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import model as model_lib
        from repro_torch.optim import adamw
        from repro_torch.train import train_step

        self.m, self.spec, self.seed, self.dev = cell.model, cell.traffic, \
            seed, dev
        _load_kernels(self.m, True, dev)
        self.feed = traffic.TrainTraffic(self.spec, self.m["vocab_size"],
                                         seed)
        model = model_lib.build(ModelConfig(**self.m), dev)
        params = weights.nest(weights.make(self.m, seed, dev))
        self.opt_cfg = adamw.AdamWConfig(**self.spec["optimizer"])
        # the state make_train_state builds, from the benchmark's weights
        self.state = {"params": params,
                      "opt": adamw.init_state(self.opt_cfg, params),
                      "step": torch.zeros((), dtype=torch.int32, device=dev)}
        self.step_fn = train_step.make_train_step(
            model, self.opt_cfg,
            train_step.TrainSettings(microbatches=self.spec["microbatches"]))
        self.n = 0

    def step(self) -> float:
        """One step through the window's own call and feed, and the host
        read of its loss (which waits for it), as ``Trainer.run`` does."""
        self.state, metrics = self.step_fn(
            self.state, {"tokens": self.feed.batch(self.n)})
        self.n += 1
        return float(metrics["loss"])

    def first_steps(self) -> dict:
        """The first ``check_steps`` steps, and what the check reads of
        them: each loss, the first gradient as AdamW got it (its first
        moment after one step over 1 - b1: its norm and its elements at
        ``grad_index``), the parameters' change."""
        leaves = weights.leaves(self.m)
        losses, grad, sample = [], {}, {}
        for i in range(self.spec["check_steps"]):
            losses.append(self.step())
            if i == 0:
                for k, lf in enumerate(leaves):
                    mom = weights.get(self.state["opt"]["m"], lf.path)
                    b1 = 1 - self.opt_cfg.b1
                    grad[lf.path] = float(torch.linalg.vector_norm(mom)) / b1
                    sample[lf.path] = (mom.reshape(-1)[grad_index(
                        lf, self.seed, k, self.dev)].float() / b1).cpu()
        change = {lf.path: _norm_change(
            weights.get(self.state["params"], lf.path),
            weights.make_leaf(lf, self.seed, i, self.dev))
            for i, lf in enumerate(leaves)}
        return {"loss": losses, "grad_norm": grad, "grad_sample": sample,
                "change_norm": change}

    def timed(self) -> float:
        """One step of the window: its host-clock seconds."""
        t0 = time.perf_counter()
        self.step()
        return time.perf_counter() - t0

    def unit(self) -> dict:
        before = _launches()
        self.step()
        return {"B": self.spec["batch"], "T": self.spec["seq_len"],
                "launches": _delta(before, _launches())}

    def release(self) -> None:
        del self.state, self.step_fn
        _free(self.dev)


def reference_train(cell, seed: int, dev: torch.device, fp8: bool = False,
                    half: bool = False, frozen: frozenset = frozenset()
                    ) -> dict:
    """The reference's first ``check_steps`` steps from the same weights
    and tokens, float32 with the parameters kept in the dtype the
    configuration stores them in, and AdamW by its equations: the same
    readings as ``TrainRun.first_steps``.  ``fp8`` runs the control
    (every weight product in float8); ``half`` a fault (half of each
    batch left out, the mean taken over the rest), ``frozen`` another
    (the leaves at these paths never updated)."""
    m, spec = cell.model, cell.traffic
    opt = spec["optimizer"]
    feed = traffic.TrainTraffic(spec, m["vocab_size"], seed)
    leaves = weights.leaves(m)
    P = {lf.path: weights.make_leaf(lf, seed, i, dev).float()
         .requires_grad_() for i, lf in enumerate(leaves)}
    mom = {k: torch.zeros_like(p) for k, p in P.items()}
    vel = {k: torch.zeros_like(p) for k, p in P.items()}
    losses, grad, sample = [], {}, {}
    for s in range(spec["check_steps"]):
        rows = feed.half_batch(s) if half else feed.batch(s)
        tokens = torch.as_tensor(rows, device=dev).long()
        loss = plain.next_token_loss(
            cell.reference.logits(P, tokens, m, fp8=fp8, remat=True), tokens)
        grads = torch.autograd.grad(loss, list(P.values()))
        losses.append(float(loss.detach()))
        step = s + 1
        with torch.no_grad():
            gnorm = float(sum(g.square().sum() for g in grads)) ** 0.5
            scale = min(1.0, opt["grad_clip"] / (gnorm + 1e-9)) \
                if opt["grad_clip"] > 0 else 1.0
            lr = schedule(opt, step)
            bc1, bc2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
            for i, (lf, g) in enumerate(zip(leaves, grads)):
                p, k = P[lf.path], lf.path
                gf = g * scale
                if s == 0:
                    grad[k] = float(torch.linalg.vector_norm(gf))
                    sample[k] = gf.reshape(-1)[grad_index(
                        lf, seed, i, dev)].cpu()
                mom[k].mul_(opt["b1"]).add_((1 - opt["b1"]) * gf)
                vel[k].mul_(opt["b2"]).add_((1 - opt["b2"]) * gf.square())
                u = (mom[k] / bc1) / (torch.sqrt(vel[k] / bc2) + opt["eps"]) \
                    + opt["weight_decay"] * p
                if k not in frozen:
                    p.copy_((p - lr * u).to(lf.dtype).float())
        del grads, loss
    with torch.no_grad():
        change = {lf.path: _norm_change(P[lf.path], weights.make_leaf(
            lf, seed, i, dev)) for i, lf in enumerate(leaves)}
    return {"loss": losses, "grad_norm": grad, "grad_sample": sample,
            "change_norm": change}


# --- scoring ----------------------------------------------------------------

class ScoreRun:
    """The program's serving engine over the mix's batches."""

    def __init__(self, cell, seed: int, dev: torch.device):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import model as model_lib
        from repro_torch.serve.engine import Engine, ServeConfig

        self.m, self.spec, self.dev = cell.model, cell.traffic, dev
        _load_kernels(self.m, False, dev)
        self.feed = traffic.ScoreTraffic(self.spec, self.m["vocab_size"],
                                         seed)
        model = model_lib.build(ModelConfig(**self.m), dev)
        params = weights.nest(weights.make(self.m, seed, dev))
        self.engine = Engine(model, params, ServeConfig(
            max_batch=self.spec["batch"], max_len=self.spec["max_len"],
            temperature=0.0, eos_token=-1))
        # the engine keeps the logits each token was sampled from
        self.engine.keep_step_logits = True
        self.j = 0

    def warm(self) -> None:
        for prompts in self.feed.warmup():
            self.engine.generate(prompts, max_new=1)

    def timed(self) -> dict:
        """The next batch through ``Engine.generate``: its prompts, the
        engine's answers, its latency (submission to return), the engine's
        prefill time and the logits it sampled the answers from (copied
        to the host after the return)."""
        prompts = self.feed.batch(self.j)
        t0 = time.perf_counter()
        out = self.engine.generate(prompts, max_new=1)
        lat = time.perf_counter() - t0
        self.j += 1
        return {"prompts": prompts, "out": out, "latency": lat,
                "prefill": self.engine.timing["prefill_s"],
                "logits": self.engine.step_logits[0].to("cpu")}

    def unit(self) -> dict:
        before = _launches()
        done = self.timed()
        plen = max(len(p) for p in done["prompts"])
        return {"B": len(done["prompts"]), "T": plen,
                "decode_step": plen < self.spec["max_len"] - 1,
                "launches": _delta(before, _launches())}

    def release(self) -> None:
        del self.engine
        _free(self.dev)


def served(done: dict, vocab: int) -> tuple[list[int | None], int]:
    """Each request's one served token (None where the answer is not its
    prompt and one token in the vocabulary), and how many failed."""
    toks: list[int | None] = []
    for p, o in zip(done["prompts"], done["out"], strict=True):
        ok = len(o) == len(p) + 1 and 0 <= int(o[-1]) < vocab and \
            np.array_equal(np.asarray(o[:-1], dtype=np.int64), p)
        toks.append(int(o[-1]) if ok else None)
    return toks, sum(t is None for t in toks)


def sample_rows(batches: list[dict], seed: int, n: int) -> list[tuple]:
    """The requests the check compares: the longest completed one and
    ``n - 1`` others drawn from the seed, as many from each slot of the
    engine's batch as there are (so a fault in one slot shows); (batch,
    row) pairs in the order served."""
    rows = [(b, i) for b, d in enumerate(batches)
            for i in range(len(d["prompts"]))]
    longest = max(rows, key=lambda r: len(batches[r[0]]["prompts"][r[1]]))
    rng = np.random.default_rng(np.random.SeedSequence([seed, 5]))
    slots: dict[int, list[tuple]] = {}
    for r in rows:
        if r != longest:
            slots.setdefault(r[1], []).append(r)
    decks = [[rs[k] for k in rng.permutation(len(rs))]
             for _, rs in sorted(slots.items())]
    dealt = [d[k] for k in range(max(map(len, decks), default=0))
             for d in decks if k < len(d)]
    return sorted([longest] + dealt[:n - 1])


def reference_score(cell, seed: int, dev: torch.device,
                    rows: list[np.ndarray], fp8: bool = False
                    ) -> list[torch.Tensor]:
    """The reference's last-position logits (float32, on the host) of each
    padded row, one row at a time."""
    m = cell.model
    P = {lf.path: weights.make_leaf(lf, seed, i, dev).float()
         for i, lf in enumerate(weights.leaves(m))}
    out = []
    with torch.no_grad():
        for row in rows:
            tokens = torch.as_tensor(row, device=dev)[None]
            out.append(cell.reference.logits(P, tokens, m, fp8=fp8,
                                             last_only=True)[0, -1].cpu())
    return out


def padded_rows(batches: list[dict], picks: list[tuple]) -> list[np.ndarray]:
    """Each picked request as the engine ran it: its batch's padding."""
    out = []
    for b, i in picks:
        prompts = batches[b]["prompts"]
        out.append(traffic.padded_row(prompts[i],
                                      max(len(p) for p in prompts)))
    return out


# --- one run ----------------------------------------------------------------

def _window(run, seconds: float) -> tuple[list, float]:
    """Steps or batches back to back until ``seconds`` have passed; the
    last one started before then completes and counts.  Returns what each
    gave and the window's length."""
    done = []
    t0 = time.perf_counter()
    while True:
        done.append(run.timed())
        t = time.perf_counter()
        if t - t0 >= seconds:
            return done, t - t0


def run_cell(cell, seed: int, seconds: float, trace: bool,
             dev: torch.device, t_start: float) -> dict:
    """One run: returns the end-to-end values, the record, the compared
    numbers with their limits, ``correct``, ``attempted``, ``failed`` and
    what the comparison read (``detail``: the two sides' readings of a
    training cell; a scoring cell's compared rows and reference
    logits)."""
    kind = cell.traffic["kind"]
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run = (TrainRun if kind == "train" else ScoreRun)(cell, seed, dev)
    if kind == "train":
        prog = run.first_steps()
    else:
        run.warm()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    done, window_s = _window(run, seconds)
    _sync(dev)
    window_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    score = kind == "score"
    rec = Record(kind, cell.model, cell.traffic, window_s,
                 [] if score else done,
                 [d["prefill"] for d in done] if score else [],
                 [[len(p) for p in d["prompts"]] for d in done]
                 if score else [])
    if trace:
        n = cell.traffic["trace_steps" if kind == "train" else
                         "trace_batches"]
        rec.trace = _profiled(lambda: rec.traced.extend(
            run.unit() for _ in range(n)), dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    t_ref = time.perf_counter()
    phases = {"setup_s": setup_s, "window_s": window_s,
              "traced_s": t_ref - t_start - setup_s - window_s}
    values = {"setup_s": setup_s, "peak_mem_gb": window_peak / 1e9}
    if kind == "train":
        run.release()
        ref = reference_train(cell, seed, dev)
        numbers = compare.train_numbers(prog, ref)
        detail = {"prog": prog, "ref": ref}
        attempted, failed = len(done), 0
        values["train_tokens_per_s"] = \
            len(done) * run.feed.tokens_per_step / window_s
    else:
        vocab = cell.model["vocab_size"]
        answers = [served(d, vocab) for d in done]
        failed = sum(f for _, f in answers)
        attempted = sum(len(d["prompts"]) for d in done)
        lat = [d["latency"] for d in done for _ in d["prompts"]]
        values["ttft_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
        values["prefill_tokens_per_s"] = sum(
            len(p) for d in done for p in d["prompts"]) / window_s
        picks = sample_rows(done, seed, cell.traffic["check_rows"])
        run.release()
        rows = padded_rows(done, picks)
        logits = reference_score(cell, seed, dev, rows)
        gaps = [compare.logit_gap(lg, answers[b][0][i]) for (b, i), lg in
                zip(picks, logits) if answers[b][0][i] is not None]
        errs = [compare.logit_err(done[b]["logits"][i], lg)
                for (b, i), lg in zip(picks, logits)]
        numbers = {"logit_gap": max(gaps) if gaps else float("inf"),
                   "logit_err": max(errs)}
        detail = {"rows": rows, "ref_logits": logits, "picks": picks}
    phases["reference_s"] = time.perf_counter() - t_ref
    print("phases " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr)
    ok, checks = compare.judge(numbers, cell.limits)
    return {"values": values, "record": rec, "checks": checks,
            "correct": ok and failed == 0, "attempted": attempted,
            "failed": failed, "memory_peak_bytes": peak, "detail": detail}

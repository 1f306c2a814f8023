"""Lower a :class:`~repro_torch.configs.base.ModelConfig` to structural
TaskGraphs (PyTorch port of ``repro/frontend/lower.py``: plain Python over
the port's graph builder, the same graphs task for task).

This is the bridge between the repo's two halves: the model zoo
(``configs/`` knows what a gemma3 / qwen-MoE / falcon-mamba *is*) and the
PIM simulator (``core/ir`` + the resource-token engine know what a bank
*does*).  :func:`lower` turns one model into the same interconnect-
independent structural :class:`~repro_torch.core.ir.TaskGraph` the Fig-8 app
builders emit, so a model inference job flows through placement, leasing,
and the live engine session with zero new scheduler code.

Mapping (mirrors the Fig-4(b) pipeline-group convention of
:mod:`repro_torch.core.taskgraph` — subarray triples of two weight-stationary
producers around one aggregator):

* **tiled matmul stages** — every projection (attention QKV / output, MLP
  up/down, SSM in/out) becomes ``width`` output tiles spread round-robin
  over pipeline groups; the activation row-vector is *broadcast* to every
  tile's producers (one move, several destinations — the case Shared-PIM's
  shared-row broadcast wins outright), each tile runs a ``depth``-long
  mul → 64-bit move → accumulate chain, and the per-tile partials reduce
  back to the stage's home group through cross-group (→ cross-bank, once
  placed) move+add chains.
* **MoE fan-out** — layers selected by ``moe_every`` route the token to
  ``n_experts_active`` expert matmuls homed on *distinct* groups (plus the
  shared expert in place), whose outputs stream back to the token's home
  group for the weighted combine: the routed all-to-all in miniature.
* **SSM scan chains** — mamba layers run in-projection → conv → a
  *sequential* selective-scan chain whose state carries tile-to-tile in
  prefill (the recurrence the family is named for), then gate and
  out-projection.
* **prefill vs decode** — prefill is wide (``seq_tiles`` parallel token
  tiles, full stage widths, attention cost growing causally with position);
  decode is narrow (one token tile, halved stage widths, depth-dominated
  critical path — the latency-bound regime).

Graph *structure* is interconnect independent: ops carry symbolic
"add"/"mul" classes and :func:`repro_torch.core.ir.materialize` prices them per
mode, exactly like the Fig-8 builders, so one cached lowering serves every
(interconnect, placement, lease) combination of a sweep.

The lowering is deliberately **eager and logical**: every operand hand-off,
expert broadcast, and partial-sum move is emitted on virtual PEs exactly
where the dataflow says one exists, with no physical cleverness baked in.
Deciding which of those moves are redundant *once placement is known* —
same-bank hand-offs of the same value coalescing into one broadcast,
store-and-forward chains fusing — is the :mod:`repro_torch.passes` pipeline's
job (``validate -> place -> optimize -> legalize``); keeping the frontend
blind to it means one lowering serves every placement, and every
optimization is recorded in the pipeline's rewrite log instead of being
invisible frontend folklore.
"""

from __future__ import annotations

import functools

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ir
from repro_torch.core.ir import TaskGraph
from repro_torch.core.taskgraph import GROUP_PES, SLICES_32, SLICES_64

#: the two serving phases a model tenant may run
MODEL_PHASES = ("prefill", "decode")

#: registry archs exposed as serving apps (every config lowers), in the
#: port's registry order (the reference's lists them in another order)
MODEL_APPS = registry.ARCHS

#: default sequence tiles per phase (prefill parallelizes across them)
PREFILL_SEQ_TILES = 4
DECODE_SEQ_TILES = 1

#: model dimension -> stage shape quanta.  One reduction step per
#: _DEPTH_QUANTUM of contraction dim, one output tile per _WIDTH_QUANTUM of
#: output dim, clamped so the largest configs stay serving-sized.
_DEPTH_QUANTUM = 1024
_WIDTH_QUANTUM = 2048
_DEPTH_CAP = 6
_WIDTH_CAP = 8
#: scan chain steps per this much ssm_state
_SCAN_QUANTUM = 16
_SCAN_CAP = 4
#: attention-context tiles per this many resident KV tokens (decode's
#: attend-against-cache cost, prefill's attend-against-prior-turn cost)
_KV_QUANTUM = 256
_KV_CAP = 8


def kv_tiles_for(kv_len: int) -> int:
    """Attention context tiles for ``kv_len`` resident KV-cache tokens.

    0 for an empty cache (the legacy graphs' shape); otherwise
    ceil(kv_len / :data:`_KV_QUANTUM`) clamped to :data:`_KV_CAP`, so a
    session's decode-step graphs grow with its context and saturate at the
    cap — keeping the per-step graph serving-sized however long the chat.
    """
    if kv_len <= 0:
        return 0
    return _span(kv_len, _KV_QUANTUM, _KV_CAP)


def _span(dim: int, quantum: int, cap: int) -> int:
    """ceil(dim / quantum) clamped to [1, cap] — stage tile/depth counts."""
    return max(1, min(cap, -(-dim // quantum)))


def _dep(*uids) -> tuple[int, ...]:
    return tuple(u for u in uids if u is not None)


class _Composer:
    """Group-structured graph builder over a virtual PE space.

    Pipeline group ``g`` owns subarrays ``3g, 3g+1, 3g+2`` (two producers
    around one aggregator, the Fig-4(b) map), wrapped into ``n_pes``.
    Values are referred to as ``(uid, group)`` pairs living on their
    group's aggregator.
    """

    def __init__(self, n_pes: int):
        if n_pes < 1:
            raise ValueError(f"n_pes must be >= 1, got {n_pes}")
        self.b = ir.GraphBuilder()
        self.n_pes = n_pes
        self.n_groups = max(1, n_pes // GROUP_PES)

    def pes(self, group: int) -> tuple[int, int, int]:
        """(producer_a, aggregator, producer_b) subarrays of a group."""
        g = group % self.n_groups
        return (3 * g % self.n_pes, (3 * g + 1) % self.n_pes,
                (3 * g + 2) % self.n_pes)

    def agg(self, group: int) -> int:
        return self.pes(group)[1]

    def op(self, pe: int, cls: str, deps=(), tag: str = "") -> int:
        return self.b.op(pe % self.n_pes, _dep(*deps), op_class=cls, tag=tag)

    def move(self, src: int, dst, deps=(), rows: int = SLICES_32,
             tag: str = "") -> int | None:
        """Move a value between subarrays; None when nothing crosses."""
        src %= self.n_pes
        if isinstance(dst, tuple):
            dsts = tuple(sorted({d % self.n_pes for d in dst} - {src}))
            if not dsts:
                return None
            dst = dsts if len(dsts) > 1 else dsts[0]
        else:
            dst %= self.n_pes
            if dst == src:
                return None
        return self.b.move(src, dst, _dep(*deps), rows=rows, tag=tag)

    def handoff(self, val, group: int, tag: str) -> tuple[int, int]:
        """The value's uid as seen from ``group`` (moving it if needed)."""
        uid, g = val
        mv = self.move(self.agg(g), self.agg(group), deps=(uid,), tag=tag)
        return (uid if mv is None else mv, group)

    # --- stages -----------------------------------------------------------------

    def matmul(self, x, home: int, width: int, depth: int,
               tag: str) -> list[tuple[int, int]]:
        """Tiled matmul: one (partial uid, group) per output tile.

        The activation broadcasts from ``x``'s aggregator to every tile's
        first producer in one move; weights are stationary.  Tiles land on
        groups ``home, home+1, …`` round-robin.
        """
        x_uid, x_g = x
        groups = [(home + t) % self.n_groups for t in range(width)]
        bcast = self.move(self.agg(x_g),
                          tuple(self.pes(g)[0] for g in groups),
                          deps=(x_uid,), tag=f"{tag}.bcast")
        operand = x_uid if bcast is None else bcast
        outs = []
        for t, g in enumerate(groups):
            prod_a, agg, prod_b = self.pes(g)
            acc = None
            for k in range(depth):
                src = prod_a if k % 2 == 0 else prod_b
                u = self.op(src, "mul", deps=(operand,),
                            tag=f"{tag}.mul t{t}k{k}")
                mv = self.move(src, agg, deps=(u,), rows=SLICES_64,
                               tag=f"{tag}.mv")
                acc = self.op(agg, "add",
                              deps=(u if mv is None else mv, acc),
                              tag=f"{tag}.acc")
            outs.append((acc, g))
        return outs

    def reduce(self, parts, home: int, tag: str) -> tuple[int, int]:
        """Cross-group reduction of partials onto ``home`` (move + add)."""
        h_agg = self.agg(home)
        acc = None
        for uid, g in parts:
            mv = self.move(self.agg(g), h_agg, deps=(uid,),
                           tag=f"{tag}.red.mv")
            acc = self.op(h_agg, "add",
                          deps=(uid if mv is None else mv, acc),
                          tag=f"{tag}.red.add")
        return (acc, home)

    def elementwise(self, parts, cls: str, tag: str) -> list[tuple[int, int]]:
        """Per-tile elementwise op (activation, gate) in place."""
        return [(self.op(self.agg(g), cls, deps=(u,), tag=tag), g)
                for u, g in parts]

    def build(self) -> TaskGraph:
        return self.b.build()


def _layer_kind(cfg: ModelConfig, layer: int) -> str:
    """attn+mlp | moe | ssm for one layer index of the config."""
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "hybrid":
        every = max(1, cfg.attn_every or 1)
        return "attn" if cfg.attn_every and layer % every == every - 1 \
            else "ssm"
    if cfg.family == "moe":
        every = max(1, cfg.moe_every)
        return "moe" if layer % every == every - 1 else "attn"
    return "attn"                       # dense / vlm / audio


def lower(cfg: ModelConfig, phase: str = "decode", *, n_pes: int = 16,
          n_layers: int | None = None, seq_tiles: int | None = None,
          kv_tiles: int | None = None) -> TaskGraph:
    """Structural inference graph for one model config (see module doc).

    ``n_layers`` truncates (or extends — kinds cycle) the layer stack so
    serving tenants can run depth-scaled jobs; ``seq_tiles`` overrides the
    phase default (prefill :data:`PREFILL_SEQ_TILES`, decode
    :data:`DECODE_SEQ_TILES`).  ``kv_tiles`` (default 0: the legacy shape,
    bit-identical graphs) adds that many resident-context tiles to every
    attention sub-block — decode attends against the cache in
    ``max(1, kv_tiles)`` steps, prefill's causal work starts ``kv_tiles``
    deep — which is how :func:`decode_step` parameterizes a one-token graph
    by the session's current KV length.
    """
    if phase not in MODEL_PHASES:
        raise ValueError(f"unknown phase {phase!r}; pick one of "
                         f"{MODEL_PHASES}")
    layers = cfg.n_layers if n_layers is None else n_layers
    if layers < 1:
        raise ValueError(f"n_layers must be >= 1, got {layers}")
    tiles = (PREFILL_SEQ_TILES if phase == "prefill" else DECODE_SEQ_TILES) \
        if seq_tiles is None else seq_tiles
    if tiles < 1:
        raise ValueError(f"seq_tiles must be >= 1, got {tiles}")
    kv = 0 if kv_tiles is None else kv_tiles
    if not 0 <= kv <= _KV_CAP:
        raise ValueError(f"kv_tiles must be in [0, {_KV_CAP}], got {kv}")

    # stage shapes from the config's dimensions (decode: narrow)
    head_dim = cfg.head_dim or (cfg.d_model // cfg.n_heads
                                if cfg.n_heads else 0)
    qkv_dim = (cfg.n_heads + 2 * cfg.n_kv_heads) * head_dim
    d_depth = _span(cfg.d_model, _DEPTH_QUANTUM, _DEPTH_CAP)
    qkv_w = _span(qkv_dim or cfg.d_model, _WIDTH_QUANTUM, _WIDTH_CAP)
    out_w = _span(cfg.d_model, _WIDTH_QUANTUM, _WIDTH_CAP)
    mlp_w = _span(cfg.d_ff or cfg.d_model, _WIDTH_QUANTUM, _WIDTH_CAP)
    moe_w = _span(cfg.moe_d_ff or cfg.d_model, _WIDTH_QUANTUM, _WIDTH_CAP)
    shared_w = _span(cfg.shared_expert_d_ff, _WIDTH_QUANTUM, _WIDTH_CAP) \
        if cfg.shared_expert_d_ff else 0
    ssm_w = _span(cfg.d_inner or cfg.d_model, _WIDTH_QUANTUM, _WIDTH_CAP)
    scan_steps = _span(cfg.ssm_state or _SCAN_QUANTUM, _SCAN_QUANTUM,
                       _SCAN_CAP)
    if phase == "decode":
        qkv_w, out_w, mlp_w, moe_w, ssm_w = (
            max(1, w // 2) for w in (qkv_w, out_w, mlp_w, moe_w, ssm_w))
        shared_w = max(1, shared_w // 2) if shared_w else 0

    c = _Composer(n_pes)
    ng = c.n_groups

    # the residual stream: one value per sequence tile, homed round-robin
    stream = [(c.op(c.agg(s % ng), "add", tag=f"embed s{s}"), s % ng)
              for s in range(tiles)]

    for li in range(layers):
        kind = _layer_kind(cfg, li)
        nxt: list[tuple[int, int]] = []
        carry: tuple[int, int] | None = None   # scan state, tile to tile
        for s, x in enumerate(stream):
            # homes rotate layer to layer: the layer boundary itself is a
            # cross-group (cross-bank once placed) activation hand-off
            home = (s + li + 1) % ng
            t = f"L{li}s{s}"
            if kind == "ssm":
                zin = c.reduce(c.matmul(x, home, ssm_w, d_depth,
                                        f"{t}.ssm.in"), home, f"{t}.ssm.in")
                h = (c.op(c.agg(home), "mul", deps=(zin[0],),
                          tag=f"{t}.ssm.conv"), home)
                for i in range(scan_steps):
                    deps = [h[0]]
                    if i == 0 and carry is not None:
                        deps.append(c.handoff(carry, home,
                                              f"{t}.ssm.carry")[0])
                    dA = c.op(c.agg(home), "mul", deps=deps,
                              tag=f"{t}.ssm.scan{i}.mul")
                    h = (c.op(c.agg(home), "add", deps=(dA,),
                              tag=f"{t}.ssm.scan{i}.add"), home)
                carry = h
                gate = c.op(c.agg(home), "mul", deps=(h[0], zin[0]),
                            tag=f"{t}.ssm.gate")
                o = c.reduce(c.matmul((gate, home), home, out_w, d_depth,
                                      f"{t}.ssm.out"), home, f"{t}.ssm.out")
                res = c.op(c.agg(home), "add",
                           deps=(o[0], c.handoff(x, home, f"{t}.res.mv")[0]),
                           tag=f"{t}.res")
                nxt.append((res, home))
                continue

            # attention sub-block (dense / moe / hybrid-attn layers)
            ctx = c.reduce(c.matmul(x, home, qkv_w, d_depth, f"{t}.qkv"),
                           home, f"{t}.qkv")
            a = ctx[0]
            # decode attends against the cache (kv_tiles context tiles,
            # min one step); prefill's causal score/АV work starts kv_tiles
            # deep and grows with the tile position
            for i in range(max(1, kv) if phase == "decode" else kv + s + 1):
                a = c.op(c.agg(home), "mul", deps=(a,), tag=f"{t}.attn{i}")
            proj = c.reduce(c.matmul((a, home), home, out_w, d_depth,
                                     f"{t}.proj"), home, f"{t}.proj")
            res1 = c.op(c.agg(home), "add",
                        deps=(proj[0],
                              c.handoff(x, home, f"{t}.res1.mv")[0]),
                        tag=f"{t}.res1")
            if cfg.cross_attn_every and \
                    li % cfg.cross_attn_every == cfg.cross_attn_every - 1:
                xa = c.reduce(c.matmul((res1, home), home, out_w, d_depth,
                                       f"{t}.xattn"), home, f"{t}.xattn")
                res1 = c.op(c.agg(home), "add", deps=(xa[0], res1),
                            tag=f"{t}.xattn.res")

            if kind == "moe":
                router = c.op(c.agg(home), "add", deps=(res1,),
                              tag=f"{t}.router")
                parts: list[tuple[int, int]] = []
                for e in range(max(1, cfg.n_experts_active)):
                    ehome = (home + 1 + e) % ng
                    up = c.matmul((router, home), ehome, moe_w, d_depth,
                                  f"{t}.exp{e}.up")
                    parts.append(c.reduce(
                        c.elementwise(up, "mul", f"{t}.exp{e}.act"),
                        ehome, f"{t}.exp{e}.down"))
                if shared_w:
                    up = c.matmul((res1, home), home, shared_w, d_depth,
                                  f"{t}.shexp.up")
                    parts.append(c.reduce(
                        c.elementwise(up, "mul", f"{t}.shexp.act"),
                        home, f"{t}.shexp.down"))
                comb = c.reduce(parts, home, f"{t}.combine")
                mixed = comb[0]
            else:
                up = c.matmul((res1, home), home, mlp_w, d_depth,
                              f"{t}.mlp.up")
                down = c.reduce(c.elementwise(up, "mul", f"{t}.mlp.act"),
                                home, f"{t}.mlp.down")
                mixed = down[0]
            res2 = c.op(c.agg(home), "add", deps=(mixed, res1),
                        tag=f"{t}.res2")
            nxt.append((res2, home))
        stream = nxt

    # epilogue: every tile's state reduces to group 0 (final norm + logits
    # for decode's next token / the last prefill tile)
    c.reduce(stream, 0, tag="logits")
    return c.build()


@functools.lru_cache(maxsize=None)
def _model_struct(arch: str, phase: str, n_pes: int,
                  n_layers: int | None, seq_tiles: int | None,
                  kv_tiles: int | None = None) -> TaskGraph:
    return lower(registry.get(arch), phase, n_pes=n_pes, n_layers=n_layers,
                 seq_tiles=seq_tiles, kv_tiles=kv_tiles)


def model_struct(arch: str, phase: str = "decode", n_pes: int = 16,
                 n_layers: int | None = None, seq_tiles: int | None = None,
                 kv_tiles: int | None = None) -> TaskGraph:
    """Memoized structural graph for a registry model (the app entry)."""
    if arch not in MODEL_APPS:
        raise ValueError(f"unknown arch {arch!r}; known: {MODEL_APPS}")
    return _model_struct(arch, phase, n_pes, n_layers, seq_tiles, kv_tiles)


def decode_step(arch: str, *, n_pes: int = 16, kv_len: int = 0,
                n_layers: int | None = None) -> TaskGraph:
    """One-token decode graph parameterized by the session's KV length.

    The continuous-batching runtime chains these: every decoded token is
    one small spliced job whose attention cost reflects the KV cache
    resident in the session's banks (via :func:`kv_tiles_for`, quantized so
    the memoized graph population stays bounded).  ``kv_len=0`` is exactly
    the legacy whole-job decode graph.
    """
    if kv_len < 0:
        raise ValueError(f"kv_len must be >= 0, got {kv_len}")
    return model_struct(arch, "decode", n_pes, n_layers,
                        kv_tiles=kv_tiles_for(kv_len))


#: the (keyword, default) signature every model app registers with
#: :func:`repro_torch.core.taskgraph.register_app` — matching the builtin apps'
#: derived signatures, so ``structural(arch, n_pes=…, phase=…)`` dispatches
MODEL_PARAMS = (("phase", "decode"), ("n_pes", 16), ("n_layers", None),
                ("seq_tiles", None), ("kv_tiles", None))

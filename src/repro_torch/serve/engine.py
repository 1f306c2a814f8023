"""Batched serving engine (PyTorch port of ``repro/serve/engine.py``).

Static max-batch slots, one batched prefill of left-padded prompts into the
decode cache (K/V, a Mamba model's conv and SSM state, or both for the
hybrid), then lockstep
decode with greedy or temperature sampling and per-slot EOS.  As in the
reference, pads are token 0 and are not masked (a Mamba model runs them
through its state), and all slots share one position.  The VLM and audio
families take one media array a batch (the stub frontends' output), float32
zeros unless the caller gives one.

While a ``torch.profiler`` records (the one switch of
``repro_torch.obs.spans``; off, a span is one boolean test), ``generate``
emits the spans ``serve.generate`` (the whole call), ``serve.prefill``
(the ``Model.prefill`` call alone) and ``serve.decode_step`` (each
lockstep iteration: ``decode_step``, sampling and the host copy of the
tokens), and adds to the counters ``serve.prompt_tokens`` (the prompts'
lengths), ``serve.padded_tokens`` (B x the longest prompt, less those
lengths) and ``serve.discarded_steps`` (decode steps whose sampled token
``generate`` does not return: with ``max_new=1``, the one step run below
``max_len - 1``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.obs import spans


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256
    temperature: float = 0.0     # 0 -> greedy
    eos_token: int = 1
    seed: int = 0


class Engine:
    def __init__(self, model: Model, params, cfg: ServeConfig):
        self.model = model
        self.params = params
        self.cfg = cfg
        # filled by each generate(): host-clock seconds of the prefill and of
        # the decode steps (each ends in a device->host copy of the sampled
        # tokens, so the clock covers the device work); with
        # ``keep_step_logits`` set, also the sampled-position logits of
        # every step, (B, V) each, kept on the device (off by default, as
        # the reference keeps none)
        self.timing: dict[str, float] = {}
        self.keep_step_logits = False
        self.step_logits: list[torch.Tensor] = []

    @torch.no_grad()
    def generate(self, prompts: list[list[int]], max_new: int = 32,
                 media=None) -> list[list[int]]:
        """Generate continuations for a batch of prompts (one static batch).

        Prompts are left-padded to a common length so a single batched
        prefill fills every slot's cache; decode then proceeds lockstep with
        per-slot EOS masking.  ``media`` (numpy or torch, (B,
        n_media_tokens, media_embed_dim)) goes to prefill and to every
        decode step, as in the reference.
        """
        with spans.span("serve.generate", self.model.device):
            return self._generate(prompts, max_new, media)

    def _generate(self, prompts: list[list[int]], max_new: int,
                  media) -> list[list[int]]:
        cfg = self.cfg
        B = len(prompts)
        if B > cfg.max_batch:
            raise ValueError(f"{B} prompts > max_batch {cfg.max_batch}")
        dev = self.model.device
        plen = max(len(p) for p in prompts)
        toks = np.zeros((B, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p          # left-pad
        n_prompt = sum(len(p) for p in prompts)
        spans.count("serve.prompt_tokens", n_prompt)
        spans.count("serve.padded_tokens", B * plen - n_prompt)
        mcfg = self.model.cfg
        if media is not None:
            media = torch.as_tensor(media, device=dev)
        elif mcfg.n_media_tokens:
            media = torch.zeros((B, mcfg.n_media_tokens, mcfg.media_embed_dim),
                                dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.step_logits = []
        t0 = time.perf_counter()
        cache = self.model.init_cache(B, cfg.max_len)
        with spans.span("serve.prefill", dev):
            logits, cache = self.model.prefill(
                self.params, cache, torch.as_tensor(toks, device=dev), media)
        cur = self._sample(logits, gen)
        cur_host = cur[:, 0].tolist()
        t1 = time.perf_counter()
        out = [list(p) for p in prompts]
        done = np.zeros(B, bool)
        steps = dropped = 0
        for _ in range(max_new):
            for i in range(B):
                if not done[i]:
                    out[i].append(cur_host[i])
                    done[i] |= cur_host[i] == cfg.eos_token
            if done.all() or cache["pos"] >= cfg.max_len - 1:
                break
            with spans.span("serve.decode_step", dev):
                logits, cache = self.model.decode_step(self.params, cache,
                                                       cur, media)
                cur = self._sample(logits, gen)
                cur_host = cur[:, 0].tolist()
            steps += 1
        else:
            dropped = int(steps > 0)     # the last step's token is not kept
        spans.count("serve.discarded_steps", dropped)
        t2 = time.perf_counter()
        self.timing = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                       "decode_steps": steps}
        return out

    def _sample(self, logits: torch.Tensor, gen: torch.Generator
                ) -> torch.Tensor:
        lg = logits[:, -1, :]
        if self.keep_step_logits:
            self.step_logits.append(lg)
        if self.cfg.temperature <= 0:
            return torch.argmax(lg, dim=-1)[:, None]
        probs = torch.softmax(lg.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

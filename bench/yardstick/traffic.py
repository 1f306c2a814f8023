"""The one traffic generator: it reads a mix's parameters (a file under
``bench/traffic/``) and makes the run's inputs from ``--seed``.

Two kinds of mix:

* ``train``: a closed loop of optimizer steps, each ``batch`` sequences
  of ``seq_len`` tokens, drawn as ``repro_torch/data/pipeline.py``'s
  ``SyntheticCorpus`` draws them (a frozen copy of its arithmetic): Zipf
  over the vocabulary, ``doc_breaks`` token-0 document breaks a row, packed
  and unmasked, a step's rows from ``SeedSequence([seed, step])``.
* ``score``: a closed loop of batches of ``batch`` prompts, each prompt
  served one token.  Prompt lengths are lognormal (``median_len``,
  ``sigma``) clipped to [``min_len``, ``max_prompt``], taken at stratified
  quantiles so that every seed serves the same lengths: a deck of
  ``cycle_batches`` batches, grouped once by ``deck_seed``, is dealt again
  every cycle with the batches and the rows within them in a new order
  from the seed, and new Zipf tokens.  So the work a cycle is the same on
  every seed, and only its order and the token ids change.
"""

from __future__ import annotations

import statistics

import numpy as np


def zipf_probs(vocab: int, exponent: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -float(exponent)
    return p / p.sum()


class TrainTraffic:
    """Token batches of a ``train`` mix."""

    def __init__(self, spec: dict, vocab: int, seed: int):
        self.spec, self.vocab, self.seed = spec, vocab, int(seed)
        self._probs = zipf_probs(vocab, spec["zipf_exponent"])

    @property
    def tokens_per_step(self) -> int:
        return self.spec["batch"] * self.spec["seq_len"]

    def batch(self, step: int) -> np.ndarray:
        """(batch, seq_len) int32 tokens of step ``step``."""
        B, T = self.spec["batch"], self.spec["seq_len"]
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        toks = rng.choice(self.vocab, size=(B, T),
                          p=self._probs).astype(np.int32)
        breaks = rng.integers(0, T, (B, self.spec["doc_breaks"]))
        for b in range(B):
            toks[b, breaks[b]] = 0
        return toks

    def half_batch(self, step: int) -> np.ndarray:
        """The first half of step ``step``'s rows (a fault's input)."""
        toks = self.batch(step)
        return toks[:toks.shape[0] // 2]


def deck_lengths(spec: dict) -> list[list[int]]:
    """The prompt lengths of one cycle, grouped into its batches: the
    lognormal's quantiles at (i + 1/2) / n, clipped, dealt into batches by
    one permutation from ``deck_seed``."""
    n = spec["cycle_batches"] * spec["batch"]
    dist = statistics.NormalDist()
    lens = [int(round(spec["median_len"] * np.exp(
        spec["sigma"] * dist.inv_cdf((i + 0.5) / n)))) for i in range(n)]
    lens = [min(max(x, spec["min_len"]), spec["max_prompt"]) for x in lens]
    order = np.random.default_rng(spec["deck_seed"]).permutation(n)
    lens = [lens[i] for i in order]
    B = spec["batch"]
    return [lens[j * B:(j + 1) * B] for j in range(spec["cycle_batches"])]


class ScoreTraffic:
    """Prompt batches of a ``score`` mix, in the order they are sent."""

    def __init__(self, spec: dict, vocab: int, seed: int):
        self.spec, self.vocab, self.seed = spec, vocab, int(seed)
        self._probs = zipf_probs(vocab, spec["zipf_exponent"])
        self._deck = deck_lengths(spec)

    def lengths(self, j: int) -> list[int]:
        """The prompt lengths of batch ``j``."""
        C = len(self._deck)
        cycle, k = divmod(j, C)
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, 1, cycle]))
        perm = rng.permutation(C)
        lens = list(self._deck[perm[k]])
        row_rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, 2, j]))
        return [lens[i] for i in row_rng.permutation(len(lens))]

    def batch(self, j: int) -> list[np.ndarray]:
        """Batch ``j``'s prompts: int64 token ids, Zipf over the vocabulary,
        none of them 0 (the engine's pad)."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, 3, j]))
        return [1 + rng.choice(self.vocab - 1, size=n, p=self._probs[:-1]
                               / self._probs[:-1].sum()).astype(np.int64)
                for n in self.lengths(j)]

    def warmup(self) -> list[list[np.ndarray]]:
        """The batches set-up serves before the window: the deck's longest
        (the traffic's largest shape) and its shortest padded one, from
        their own streams."""
        deck = self._deck
        longest = max(range(len(deck)), key=lambda k: max(deck[k]))
        shortest = min(range(len(deck)), key=lambda k: max(deck[k]))
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 4]))
        return [[rng.integers(1, self.vocab, n, dtype=np.int64)
                 for n in deck[k]] for k in (longest, shortest)]


def padded_row(prompt: np.ndarray, plen: int) -> np.ndarray:
    """A prompt as the engine runs it in a batch padded to ``plen``: left
    padded with token 0."""
    row = np.zeros(plen, np.int64)
    row[plen - len(prompt):] = prompt
    return row

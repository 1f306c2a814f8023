"""Dynamic tenancy: bank-set leasing with pluggable admission policies
(PyTorch port of ``repro/runtime/allocator.py``).

The serving runtime multiplexes many tenants onto one device by leasing
each admitted job an exclusive *bank set* — the unit of spatial isolation
the paper's interconnects actually contend over (a tenant inside its own
banks only meets its neighbors on the shared bank-group / channel buses,
where Shared-PIM's store-and-forward keeps flowing and LISA's circuit
switching stalls).  Jobs that do not fit queue; leases release on job
completion and the freed banks admit queued work.

Admission policies (:data:`ADMISSION_POLICIES`):

* ``fifo``     — strict arrival order; a large job at the head blocks the
  queue (no backfill), the baseline any fairness argument starts from.
* ``sjf``      — shortest job first by the caller-supplied cost estimate
  (the serving runtime passes the job graph's task count); classic
  latency-optimal, starvation-prone.
* ``priority`` — highest tenant priority first, FIFO within a priority.

Selection within a policy is deterministic: ties break on the admission
sequence number, and bank picking prefers *group-aligned contiguous* free
runs (contiguous banks inside one bank group share the cheapest bus route
class), then any contiguous run, before falling back to the lowest free
banks.

Continuous batching (:class:`ContinuousAllocator`) splits the fused
job/lease lifecycle in two: a :class:`Residency` is a tenant's persistent
KV bank set — held across many decode-step jobs, growing with the decoded
context — while prefill still flows through the classic policy queue, but
capped to a separate bank pool so decode residencies always have head
room.  Per-step :class:`StepGrant` records tie each spliced decode job to
its residency; :meth:`ContinuousAllocator.preempt` releases a running
prefill's *compute* (its lease) back to the pool and requeues it ahead of
everything, and residency *migration* re-places a KV set to defragment
banks — both sets are held until :meth:`ContinuousAllocator
.commit_migration`, so bank conservation holds mid-flight.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any

from repro_torch.device.geometry import DeviceGeometry

ADMISSION_POLICIES = ("fifo", "sjf", "priority")


@dataclasses.dataclass(frozen=True)
class Lease:
    """An exclusive grant of ``banks`` to one admitted job."""

    ticket: int                  # allocator-wide admission sequence number
    banks: tuple[int, ...]
    payload: Any = None          # whatever the caller attached to request()


class BankAllocator:
    """Bank-set leasing with FIFO / SJF / priority admission (see module)."""

    def __init__(self, geom: DeviceGeometry, policy: str = "fifo"):
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; pick one "
                             f"of {ADMISSION_POLICIES}")
        self.geom = geom
        self.policy = policy
        self._free: set[int] = set(range(geom.n_banks))
        self._queue: list = []               # heap of (key, banks, payload)
        self._active: dict[int, Lease] = {}  # ticket -> outstanding lease
        self._seq = 0

    # --- introspection ----------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_leased(self) -> int:
        return len(self._active)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def n_banks_leased(self) -> int:
        """Banks currently held by outstanding leases."""
        return self.geom.n_banks - len(self._free)

    @property
    def occupancy(self) -> float:
        """Fraction of the device's banks currently leased (0..1) — the
        lease-occupancy series the serving metrics sample over time."""
        return self.n_banks_leased / self.geom.n_banks

    @property
    def queued_bank_demand(self) -> int:
        """Banks the queued jobs are waiting for, summed (queue pressure
        in the same unit as capacity, unlike a bare job count)."""
        return sum(banks for _key, banks, _payload in self._queue)

    def free_banks(self) -> tuple[int, ...]:
        return tuple(sorted(self._free))

    # --- requests / releases ----------------------------------------------------

    def request(self, banks: int, *, priority: int = 0, cost: float = 0.0,
                payload: Any = None) -> list[Lease]:
        """Queue one job wanting ``banks`` banks; return any new leases.

        The request joins the queue and admission runs immediately, so the
        returned leases may include this job, earlier queued jobs the
        policy now prefers, or nothing.  Match leases to jobs via
        ``lease.payload``.
        """
        if not 1 <= banks <= self.geom.n_banks:
            raise ValueError(
                f"job wants {banks} banks; device has {self.geom.n_banks}")
        if self.policy == "sjf":
            key = (cost, self._seq)
        elif self.policy == "priority":
            key = (-priority, self._seq)
        else:
            key = (self._seq,)
        heapq.heappush(self._queue, (key, banks, payload))
        self._seq += 1
        return self._drain()

    def release(self, lease: Lease) -> list[Lease]:
        """Return a lease's banks and admit whatever now fits.

        Only leases this allocator granted and has not yet released are
        accepted; a stale or foreign lease raises ``ValueError``.  (The
        pre-fix code only cross-checked the freed banks against the *free*
        set, so releasing a stale lease whose banks had already been
        re-leased silently freed another tenant's banks mid-job.)
        """
        active = self._active.get(lease.ticket)
        if active is None:
            raise ValueError(
                f"unknown or already-released lease ticket {lease.ticket} "
                f"(banks {list(lease.banks)}); outstanding tickets: "
                f"{sorted(self._active)}")
        if active.banks != lease.banks:
            raise ValueError(
                f"lease ticket {lease.ticket} was granted banks "
                f"{list(active.banks)}, not {list(lease.banks)}")
        del self._active[lease.ticket]
        self._free.update(lease.banks)
        return self._drain()

    def _drain(self) -> list[Lease]:
        """Admit from the queue head (policy order) while jobs fit."""
        granted = []
        while self._queue and self._queue[0][1] <= len(self._free):
            _key, banks, payload = heapq.heappop(self._queue)
            picked = self._pick_banks(banks)
            self._free.difference_update(picked)
            lease = Lease(self._seq, picked, payload)
            self._active[lease.ticket] = lease
            granted.append(lease)
            self._seq += 1
        return granted

    def _pick_banks(self, k: int) -> tuple[int, ...]:
        """Best contiguous free run of ``k`` banks, else lowest ``k``.

        Contiguous runs are ranked by (bank groups spanned, starts on a
        group boundary, lowest index): a run inside one group keeps every
        cross-bank hop on the ``"group"`` route class — the cheapest shared
        bus — and a group-aligned start minimizes straddle when a run must
        span groups.  On a single-group geometry this degenerates to the
        old lowest-contiguous-run rule.
        """
        free = sorted(self._free)
        bpg = self.geom.banks_per_group
        best = best_key = None
        for i in range(len(free) - k + 1):
            lo, hi = free[i], free[i + k - 1]
            if hi - lo != k - 1:
                continue
            spanned = self.geom.group_of_bank(hi) \
                - self.geom.group_of_bank(lo) + 1
            key = (spanned, lo % bpg != 0, lo)
            if best_key is None or key < best_key:
                best, best_key = tuple(free[i:i + k]), key
        return best if best is not None else tuple(free[:k])


# --- continuous batching: residencies + step grants ------------------------------


@dataclasses.dataclass
class Residency:
    """A tenant's persistent KV bank set — it outlives every job run on it.

    Unlike a :class:`Lease` (one job, frozen), a residency is mutable
    state: ``kv_tokens`` grows per decoded token, ``banks`` may be extended
    in place or re-placed by migration, and ``steps_granted`` counts the
    decode-step jobs that have run against it.  ``migrating_to`` holds the
    destination bank set between ``begin_migration`` and
    ``commit_migration`` — while set, *both* sets are charged against the
    device (bank conservation never goes negative mid-copy).
    """

    rid: int
    tenant: str
    banks: tuple[int, ...]
    kv_tokens: int = 0
    steps_granted: int = 0
    migrating_to: tuple[int, ...] | None = None


@dataclasses.dataclass(frozen=True)
class StepGrant:
    """One decode-step's right to compute on its residency's banks."""

    rid: int
    step: int                    # per-residency step sequence number
    banks: tuple[int, ...]


class ContinuousAllocator(BankAllocator):
    """Bank allocator for iteration-level continuous batching.

    Prefill keeps the inherited policy queue but is *pool-capped*: leases
    for queued prefill may never hold more than ``n_banks -
    decode_reserve`` banks in total, so residencies (decode KV) always
    have room to land and grow.  Decode never queues for banks — a
    session's steps run on its residency via :meth:`grant_step`.

    The serving loop, not the allocator, decides *when* re-admission is
    causally safe: :meth:`preempt` and :meth:`adopt` never drain, and
    setting :attr:`admission_paused` holds the whole queue (the runtime
    pauses it while queued decode steps are at risk of missing their
    per-token deadline, then calls :meth:`drain`).
    """

    def __init__(self, geom: DeviceGeometry, policy: str = "fifo", *,
                 decode_reserve: int | None = None,
                 tokens_per_bank: int = 512):
        super().__init__(geom, policy)
        if decode_reserve is None:
            decode_reserve = geom.n_banks // 2
        if not 0 <= decode_reserve < geom.n_banks:
            raise ValueError(
                f"decode_reserve must be in [0, {geom.n_banks}), got "
                f"{decode_reserve}")
        if tokens_per_bank < 1:
            raise ValueError(
                f"tokens_per_bank must be >= 1, got {tokens_per_bank}")
        self.decode_reserve = decode_reserve
        self.tokens_per_bank = tokens_per_bank
        self.admission_paused = False
        self._resident: dict[int, Residency] = {}
        self._prefill_held = 0
        self._rid = 0
        self._preempt_seq = 0

    # --- introspection ----------------------------------------------------------

    @property
    def prefill_pool(self) -> int:
        """Banks prefill leases may collectively hold."""
        return self.geom.n_banks - self.decode_reserve

    @property
    def n_resident(self) -> int:
        return len(self._resident)

    @property
    def n_banks_resident(self) -> int:
        """Banks held by residencies (both sets of a mid-flight migration)."""
        return sum(len(r.banks) + len(r.migrating_to or ())
                   for r in self._resident.values())

    @property
    def n_banks_prefill(self) -> int:
        """Banks held by outstanding prefill leases."""
        return self._prefill_held

    def residencies(self) -> tuple[Residency, ...]:
        return tuple(self._resident[rid] for rid in sorted(self._resident))

    def banks_for(self, kv_tokens: int) -> int:
        """Residency footprint for ``kv_tokens`` of KV cache (>= 1 bank)."""
        if kv_tokens <= 0:
            return 1
        return min(self.geom.n_banks,
                   -(-kv_tokens // self.tokens_per_bank))

    # --- the prefill pool (queued, policy-ordered, capped) ----------------------

    def request(self, banks: int, *, priority: int = 0, cost: float = 0.0,
                payload: Any = None) -> list[Lease]:
        if banks > self.prefill_pool:
            raise ValueError(
                f"prefill job wants {banks} banks; the prefill pool is "
                f"{self.prefill_pool} (decode_reserve="
                f"{self.decode_reserve} of {self.geom.n_banks})")
        return super().request(banks, priority=priority, cost=cost,
                               payload=payload)

    def _drain(self) -> list[Lease]:
        granted = []
        while not self.admission_paused and self._queue:
            banks = self._queue[0][1]
            if banks > len(self._free) \
                    or self._prefill_held + banks > self.prefill_pool:
                break
            _key, banks, payload = heapq.heappop(self._queue)
            picked = self._pick_banks(banks)
            self._free.difference_update(picked)
            lease = Lease(self._seq, picked, payload)
            self._active[lease.ticket] = lease
            self._prefill_held += len(picked)
            granted.append(lease)
            self._seq += 1
        return granted

    def drain(self) -> list[Lease]:
        """Admit whatever now fits (the runtime's explicit re-admission
        point after :meth:`preempt` / :meth:`adopt` / unpausing)."""
        return self._drain()

    def release(self, lease: Lease) -> list[Lease]:
        self._validate_active(lease)
        self._prefill_held -= len(lease.banks)
        return super().release(lease)

    def preempt(self, lease: Lease) -> None:
        """Evict a running prefill: free its banks, requeue it *ahead of
        every queued job* (whatever the policy), and do **not** drain —
        the caller re-admits (:meth:`drain`) once the decode deadline
        pressure that forced the preemption has cleared.
        """
        self._validate_active(lease)
        del self._active[lease.ticket]
        self._free.update(lease.banks)
        self._prefill_held -= len(lease.banks)
        key = (float("-inf"), self._preempt_seq)
        self._preempt_seq += 1
        heapq.heappush(self._queue, (key, len(lease.banks), lease.payload))

    def _validate_active(self, lease: Lease) -> None:
        active = self._active.get(lease.ticket)
        if active is None:
            raise ValueError(
                f"unknown or already-released lease ticket {lease.ticket}; "
                f"outstanding tickets: {sorted(self._active)}")
        if active.banks != lease.banks:
            raise ValueError(
                f"lease ticket {lease.ticket} was granted banks "
                f"{list(active.banks)}, not {list(lease.banks)}")

    # --- residencies ------------------------------------------------------------

    def acquire(self, tenant: str, kv_tokens: int = 0) -> Residency | None:
        """A fresh residency sized for ``kv_tokens``, or None if the banks
        are not free right now (the caller retries on a later release)."""
        need = self.banks_for(kv_tokens)
        if need > len(self._free):
            return None
        picked = self._pick_banks(need)
        self._free.difference_update(picked)
        return self._register(tenant, picked, kv_tokens)

    def adopt(self, lease: Lease, tenant: str, kv_tokens: int) -> Residency:
        """Convert a completed prefill's lease into a residency *in place*.

        The KV the prefill produced already lives in the lease's banks, so
        adoption moves no data: the residency keeps the first
        ``banks_for(kv_tokens)`` of them (surplus banks return to the
        pool) and best-effort extends from free banks if the KV needs
        more.  Never drains — the caller re-admits via :meth:`drain`.
        """
        self._validate_active(lease)
        del self._active[lease.ticket]
        self._prefill_held -= len(lease.banks)
        need = self.banks_for(kv_tokens)
        banks = lease.banks
        if need < len(banks):
            self._free.update(banks[need:])
            banks = banks[:need]
        elif need > len(banks):
            banks = banks + self._extend(banks, need - len(banks))
        return self._register(tenant, banks, kv_tokens)

    def grow(self, res: Residency, tokens: int) -> bool:
        """Account ``tokens`` more KV; extend the bank set if the footprint
        crossed a bank boundary.  False = the residency is now over-packed
        (no free bank to extend into) — the migration trigger.
        """
        self._check_resident(res)
        if res.migrating_to is not None:
            raise ValueError(f"residency {res.rid} is mid-migration")
        res.kv_tokens += tokens
        need = self.banks_for(res.kv_tokens)
        if need > len(res.banks):
            res.banks = res.banks + self._extend(res.banks,
                                                 need - len(res.banks))
        return len(res.banks) >= need

    def grant_step(self, res: Residency) -> StepGrant:
        """The next decode-step grant on a residency's current banks."""
        self._check_resident(res)
        grant = StepGrant(res.rid, res.steps_granted, res.banks)
        res.steps_granted += 1
        return grant

    def begin_migration(self, res: Residency) -> tuple[int, ...] | None:
        """Reserve a fresh (defragmented) placement for the residency's KV.

        Returns the destination bank set — held *alongside* the source
        until :meth:`commit_migration`, so the copy the runtime prices via
        the move cost model has somewhere real to land — or None when the
        device cannot host a second copy right now.
        """
        self._check_resident(res)
        if res.migrating_to is not None:
            raise ValueError(f"residency {res.rid} is already migrating")
        need = self.banks_for(res.kv_tokens)
        if need > len(self._free):
            return None
        dst = self._pick_banks(need)
        self._free.difference_update(dst)
        res.migrating_to = dst
        return dst

    def commit_migration(self, res: Residency) -> None:
        """The copy landed: source banks free, destination becomes home."""
        self._check_resident(res)
        if res.migrating_to is None:
            raise ValueError(f"residency {res.rid} is not migrating")
        self._free.update(res.banks)
        res.banks, res.migrating_to = res.migrating_to, None

    def abort_migration(self, res: Residency) -> None:
        """Give the reserved destination back (copy never ran)."""
        self._check_resident(res)
        if res.migrating_to is None:
            raise ValueError(f"residency {res.rid} is not migrating")
        self._free.update(res.migrating_to)
        res.migrating_to = None

    def release_residency(self, res: Residency) -> list[Lease]:
        """Session over: free the KV banks (both sets if mid-migration)
        and admit whatever prefill now fits."""
        self._check_resident(res)
        del self._resident[res.rid]
        self._free.update(res.banks)
        if res.migrating_to is not None:
            self._free.update(res.migrating_to)
            res.migrating_to = None
        return self._drain()

    def _register(self, tenant: str, banks: tuple[int, ...],
                  kv_tokens: int) -> Residency:
        res = Residency(self._rid, tenant, tuple(banks), kv_tokens)
        self._rid += 1
        self._resident[res.rid] = res
        return res

    def _check_resident(self, res: Residency) -> None:
        if self._resident.get(res.rid) is not res:
            raise ValueError(
                f"unknown or released residency {res.rid} "
                f"(tenant {res.tenant!r}); resident: "
                f"{sorted(self._resident)}")

    def _extend(self, banks: tuple[int, ...], k: int) -> tuple[int, ...]:
        """Up to ``k`` free banks to append, nearest route class first:
        same group as an existing bank, then lowest index."""
        groups = {self.geom.group_of_bank(b) for b in banks}
        ranked = sorted(self._free,
                        key=lambda b: (self.geom.group_of_bank(b)
                                       not in groups, b))
        picked = tuple(ranked[:k])
        self._free.difference_update(picked)
        return picked

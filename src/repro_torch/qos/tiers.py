"""QoS tiers: per-request priority, deadline, and SLO value (docs/QOS.md).

Every query in the repo used to be identical — one SLO, one priority.
A :class:`QosTier` names a class of traffic (``interactive`` vs.
``best_effort``), carrying a *priority class* (who preempts whom at
batch formation), a *per-request deadline distribution* (seconds from
arrival), and an *SLO value* (what meeting that deadline is worth).
A :class:`TierAssigner` stamps every arrival with a tier draw — the
same seeded draw in the simulator and the live engine, so sim/live
runs see bit-identical tier sequences.

The stamped run is a :class:`TierPlan`: flat per-query arrays
(``tier_ids`` / ``priorities`` / ``deadlines`` / ``values``) that the
run loop indexes by global query id.  Drivers construct plans through
:func:`resolve_tiers`, mirroring ``resolve_lengths`` /
``resolve_admission``: a spec (names, ``QosTier`` objects, an
assigner, or a pre-built plan) in, a plan (or ``None`` — tiers
unarmed, bit-identical to the pre-QoS behaviour) out.

Deadline samplers are seeded and deterministic, registered by name
like the length samplers:

* ``fixed`` — every request the same deadline.
* ``uniform`` — deadlines uniform in ``[lo, hi]``.

Preset tiers live in a registry (``register_tier`` /
``get_tier``), so ``tiers="interactive,best_effort"`` works anywhere
a tier spec is accepted.

The port's copy of the JAX package's ``qos/tiers.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type, Union

import numpy as np

# Distinct salts keep the tier-mixture draw and the per-tier deadline
# draws on independent streams of the same user seed.
_ASSIGN_SALT = 0x71A5
_DEADLINE_SALT = 0xD17E


# ------------------------------------------------------------------
# Deadline samplers
# ------------------------------------------------------------------

_DEADLINES: Dict[str, Type] = {}


def register_deadlines(name: str) -> Callable[[Type], Type]:
    """Class decorator registering a deadline sampler under ``name``."""
    def deco(cls: Type) -> Type:
        if name in _DEADLINES:
            raise ValueError(f"deadline sampler {name!r} already registered")
        _DEADLINES[name] = cls
        return cls
    return deco


def available_deadlines() -> List[str]:
    """Sorted names of every registered deadline sampler."""
    return sorted(_DEADLINES)


def make_deadlines(name: str, **kwargs):
    """Construct the deadline sampler registered under ``name``."""
    if name not in _DEADLINES:
        raise ValueError(f"unknown deadline sampler {name!r}; "
                         f"available: {available_deadlines()}")
    return _DEADLINES[name](**kwargs)


@register_deadlines("fixed")
class FixedDeadlines:
    """Every request the same relative deadline (``inf`` = no deadline)."""

    def __init__(self, deadline: float = math.inf):
        if not deadline > 0:
            raise ValueError(f"deadline must be > 0, got {deadline}")
        self.deadline = float(deadline)

    def sample(self, num_queries: int, rng: np.random.Generator) -> np.ndarray:
        return np.full(num_queries, self.deadline, dtype=np.float64)


@register_deadlines("uniform")
class UniformDeadlines:
    """Per-request deadlines uniform in ``[lo, hi]`` seconds."""

    def __init__(self, lo: float, hi: float):
        if not 0 < lo <= hi or not math.isfinite(hi):
            raise ValueError(f"need 0 < lo <= hi (finite), got [{lo}, {hi}]")
        self.lo, self.hi = float(lo), float(hi)

    def sample(self, num_queries: int, rng: np.random.Generator) -> np.ndarray:
        return rng.uniform(self.lo, self.hi, size=num_queries)


# ------------------------------------------------------------------
# Tier model
# ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QosTier:
    """One traffic class: priority, deadline distribution, SLO value.

    ``priority`` orders preemption (higher preempts lower at batch
    formation and routes first under ``downgrade``); ``value`` weights
    the tier in expected-value shedding and realized-value accounting;
    ``deadline`` is a sampler name (with ``deadline_kwargs``), a
    scalar number of seconds, or a sampler instance (anything with
    ``sample(n, rng)``).
    """

    name: str
    priority: int = 0
    value: float = 1.0
    deadline: Union[str, float, object] = math.inf
    deadline_kwargs: Optional[dict] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tier name must be non-empty")
        if not self.value > 0:
            raise ValueError(f"tier value must be > 0, got {self.value}")
        if (self.deadline_kwargs
                and not isinstance(self.deadline, str)):
            raise ValueError("deadline_kwargs only apply to a sampler name")

    def deadline_sampler(self):
        """The tier's deadline distribution as a sampler object."""
        if isinstance(self.deadline, str):
            return make_deadlines(self.deadline,
                                  **(self.deadline_kwargs or {}))
        if isinstance(self.deadline, (int, float)):
            return FixedDeadlines(float(self.deadline))
        return self.deadline


# Preset registry: names usable anywhere a tier spec is accepted.
_TIERS: Dict[str, QosTier] = {}


def register_tier(tier: QosTier, name: Optional[str] = None) -> QosTier:
    """Register a preset tier under ``name`` (default: ``tier.name``)."""
    key = name or tier.name
    if key in _TIERS:
        raise ValueError(f"tier {key!r} already registered")
    _TIERS[key] = tier
    return tier


def unregister_tier(name: str) -> None:
    """Remove a preset registration (tests / plugin reload)."""
    if name not in _TIERS:
        raise ValueError(f"tier {name!r} is not registered")
    del _TIERS[name]


def available_tiers() -> List[str]:
    """Sorted names of every registered preset tier."""
    return sorted(_TIERS)


def get_tier(name: str) -> QosTier:
    """Look up a preset tier by name."""
    if name not in _TIERS:
        raise ValueError(f"unknown tier {name!r}; "
                         f"available: {available_tiers()}")
    return _TIERS[name]


# The classic three-class split: latency-critical chat traffic, paid
# API traffic with a looser objective, and free-tier batch work that
# is worth serving but never worth displacing the first two.
register_tier(QosTier("interactive", priority=2, value=10.0, deadline=0.5))
register_tier(QosTier("standard", priority=1, value=2.0, deadline=2.0))
register_tier(QosTier("best_effort", priority=0, value=1.0, deadline=10.0))


# ------------------------------------------------------------------
# Per-run stamping
# ------------------------------------------------------------------

@dataclasses.dataclass
class TierPlan:
    """Per-query tier stamps for one run, indexed by global query id.

    ``deadlines`` are *relative* (seconds from the query's arrival);
    the run loop compares completion − arrival against them.  Arrays
    are plain numpy so a cluster can pre-size an empty plan per
    replica and stamp entries in assignment order.
    """

    tiers: Tuple[QosTier, ...]
    tier_ids: np.ndarray     # int64 [n] — index into ``tiers``
    priorities: np.ndarray   # int64 [n]
    deadlines: np.ndarray    # float64 [n] — relative, seconds
    values: np.ndarray       # float64 [n]

    def __post_init__(self):
        n = len(self.tier_ids)
        if not (len(self.priorities) == len(self.deadlines)
                == len(self.values) == n):
            raise ValueError("tier plan arrays must share one length")

    def __len__(self) -> int:
        return len(self.tier_ids)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tiers)

    def take(self, num_queries: int) -> "TierPlan":
        """The plan truncated to the first ``num_queries`` stamps."""
        if num_queries > len(self):
            raise ValueError(f"tier plan covers {len(self)} queries, "
                             f"run needs {num_queries}")
        if num_queries == len(self):
            return self
        return TierPlan(self.tiers, self.tier_ids[:num_queries],
                        self.priorities[:num_queries],
                        self.deadlines[:num_queries],
                        self.values[:num_queries])

    @classmethod
    def empty(cls, tiers: Sequence[QosTier], capacity: int) -> "TierPlan":
        """A zeroed plan a cluster stamps in assignment order."""
        return cls(tuple(tiers),
                   np.zeros(capacity, dtype=np.int64),
                   np.zeros(capacity, dtype=np.int64),
                   np.full(capacity, math.inf, dtype=np.float64),
                   np.ones(capacity, dtype=np.float64))

    def stamp(self, local: int, source: "TierPlan", fleet_q: int) -> None:
        """Copy ``source``'s stamp for ``fleet_q`` into slot ``local``."""
        self.tier_ids[local] = source.tier_ids[fleet_q]
        self.priorities[local] = source.priorities[fleet_q]
        self.deadlines[local] = source.deadlines[fleet_q]
        self.values[local] = source.values[fleet_q]


@dataclasses.dataclass(frozen=True)
class QosRequest:
    """One arrival's QoS context, as handed to tier-aware routers.

    ``deadline`` here is *absolute* (arrival + relative deadline), so
    a router can compare it against projected completion times
    directly.
    """

    query: int
    tier: int
    priority: int
    deadline: float
    value: float


class TierAssigner:
    """Stamps arrivals with tiers: a seeded draw over a tier mixture.

    ``shares`` weight the mixture (normalized; default uniform).  The
    assignment and each tier's deadline draws run on independent
    seeded streams, so adding a tier perturbs neither the other
    tiers' deadlines nor the assignment of queries it does not claim
    beyond the mixture change itself.
    """

    def __init__(self, tiers: Sequence[QosTier],
                 shares: Optional[Sequence[float]] = None, seed: int = 0):
        tiers = tuple(tiers)
        if not tiers:
            raise ValueError("need at least one tier")
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"tier names must be unique, got {names}")
        if shares is None:
            shares = [1.0] * len(tiers)
        shares = np.asarray(shares, dtype=np.float64)
        if len(shares) != len(tiers) or np.any(shares < 0) or shares.sum() <= 0:
            raise ValueError("shares must be non-negative, sum > 0, and "
                             "match the tier count")
        self.tiers = tiers
        self.shares = shares / shares.sum()
        self.seed = int(seed)

    def assign(self, num_queries: int) -> TierPlan:
        rng = np.random.default_rng((self.seed, _ASSIGN_SALT))
        tier_ids = rng.choice(len(self.tiers), size=num_queries,
                              p=self.shares).astype(np.int64)
        priorities = np.array([t.priority for t in self.tiers],
                              dtype=np.int64)[tier_ids]
        values = np.array([t.value for t in self.tiers],
                          dtype=np.float64)[tier_ids]
        deadlines = np.empty(num_queries, dtype=np.float64)
        for i, tier in enumerate(self.tiers):
            mask = tier_ids == i
            drng = np.random.default_rng((self.seed, _DEADLINE_SALT, i))
            deadlines[mask] = tier.deadline_sampler().sample(
                int(mask.sum()), drng)
        return TierPlan(self.tiers, tier_ids, priorities, deadlines, values)


def resolve_tiers(tiers, tiers_kwargs: Optional[dict] = None,
                  num_queries: int = 0) -> Optional[TierPlan]:
    """One construction path for per-query tier stamps.

    ``tiers`` may be ``None`` (tiers unarmed — the run is bit-identical
    to a pre-QoS run), a pre-built :class:`TierPlan` (truncated to the
    run), an assigner (anything with ``assign``), a comma-joined
    string of preset names, or a sequence of tier specs — preset
    names, :class:`QosTier` objects, or dicts of ``QosTier`` fields.
    ``tiers_kwargs`` (``shares`` / ``seed``) apply when an assigner is
    built here.
    """
    if tiers is None:
        if tiers_kwargs:
            raise ValueError("tiers_kwargs given but no tiers selected")
        return None
    if isinstance(tiers, TierPlan):
        if tiers_kwargs:
            raise ValueError("tiers_kwargs only apply to a tier spec, "
                             "not an already-built TierPlan")
        return tiers.take(num_queries)
    if hasattr(tiers, "assign"):
        if tiers_kwargs:
            raise ValueError("tiers_kwargs only apply to a tier spec, "
                             "not an already-built assigner")
        return tiers.assign(num_queries)
    if isinstance(tiers, str):
        tiers = [part.strip() for part in tiers.split(",") if part.strip()]
    objs = []
    for spec in tiers:
        if isinstance(spec, str):
            objs.append(get_tier(spec))
        elif isinstance(spec, dict):
            objs.append(QosTier(**spec))
        else:
            objs.append(spec)
    return TierAssigner(objs, **(tiers_kwargs or {})).assign(num_queries)

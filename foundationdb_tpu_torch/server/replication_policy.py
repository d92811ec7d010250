"""Replication policy algebra over worker localities.

Reference: fdbrpc/ReplicationPolicy.h:101-168 — PolicyOne / PolicyAcross
/ PolicyAnd trees evaluated against LocalityData attribute sets
(flow/Locality.h), used by recruitment and team building to place
replicas across failure domains ("one per zone", "two per dc, each in a
distinct zone"). validate() checks an existing team; select() builds
one from candidates.

Selection walks attribute groups in candidate order (deterministic for
the simulator); because the groups partition the candidates, a greedy
scan that skips unsatisfiable groups is complete — no backtracking is
needed across disjoint groups.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class Locality:
    """Attribute set naming a process's failure domains (ref:
    flow/Locality.h LocalityData — processid/zoneid/machineid/dcid)."""

    __slots__ = ("attrs",)

    def __init__(self, **attrs: str):
        self.attrs = attrs

    def get(self, key: str) -> Optional[str]:
        return self.attrs.get(key)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Locality({self.attrs})"


Candidate = Tuple[object, Locality]


class ReplicationPolicy:
    def validate(self, localities: Sequence[Locality]) -> bool:
        raise NotImplementedError

    def select(self, candidates: Sequence[Candidate]
               ) -> Optional[List[object]]:
        """A team satisfying the policy drawn from candidates, or None."""
        raise NotImplementedError

    def replica_count(self) -> int:
        raise NotImplementedError


class PolicyOne(ReplicationPolicy):
    """Any single replica (ref: PolicyOne)."""

    def validate(self, localities: Sequence[Locality]) -> bool:
        return len(localities) >= 1

    def select(self, candidates: Sequence[Candidate]
               ) -> Optional[List[object]]:
        return [candidates[0][0]] if candidates else None

    def replica_count(self) -> int:
        return 1

    def __repr__(self) -> str:  # pragma: no cover
        return "One()"


class PolicyAcross(ReplicationPolicy):
    """`count` groups with distinct values of `attrib`, each group
    internally satisfying `inner` (ref: PolicyAcross — "Across(2,
    zoneid, One())" = two replicas in two different zones)."""

    def __init__(self, count: int, attrib: str, inner: ReplicationPolicy):
        self.count = count
        self.attrib = attrib
        self.inner = inner

    def validate(self, localities: Sequence[Locality]) -> bool:
        groups: Dict[str, List[Locality]] = {}
        for loc in localities:
            v = loc.get(self.attrib)
            if v is None:
                continue
            groups.setdefault(v, []).append(loc)
        ok = sum(1 for g in groups.values() if self.inner.validate(g))
        return ok >= self.count

    def select(self, candidates: Sequence[Candidate]
               ) -> Optional[List[object]]:
        groups: Dict[str, List[Candidate]] = {}
        order: List[str] = []
        for cand in candidates:
            v = cand[1].get(self.attrib)
            if v is None:
                continue
            if v not in groups:
                order.append(v)
            groups.setdefault(v, []).append(cand)
        team: List[object] = []
        filled = 0
        for v in order:
            if filled == self.count:
                break
            sub = self.inner.select(groups[v])
            if sub is not None:
                team.extend(sub)
                filled += 1
        return team if filled == self.count else None

    def replica_count(self) -> int:
        return self.count * self.inner.replica_count()

    def __repr__(self) -> str:  # pragma: no cover
        return f"Across({self.count},{self.attrib},{self.inner!r})"


class PolicyAnd(ReplicationPolicy):
    """All sub-policies must hold over the same team (ref: PolicyAnd).

    select() builds with the most demanding policy (largest replica
    count) and checks the rest validate over the result; a combination
    needing a team no single sub-policy would build returns None —
    matching the reference's best-effort PolicyAnd selection.
    """

    def __init__(self, policies: Sequence[ReplicationPolicy]):
        self.policies = list(policies)

    def validate(self, localities: Sequence[Locality]) -> bool:
        return all(p.validate(localities) for p in self.policies)

    def select(self, candidates: Sequence[Candidate]
               ) -> Optional[List[object]]:
        by_id = {id(c[0]): c[1] for c in candidates}
        for lead in sorted(self.policies, key=lambda p: -p.replica_count()):
            team = lead.select(candidates)
            if team is None:
                continue
            locs = [by_id[id(m)] for m in team]
            if all(p.validate(locs) for p in self.policies):
                return team
        return None

    def replica_count(self) -> int:
        return max((p.replica_count() for p in self.policies), default=0)

    def __repr__(self) -> str:  # pragma: no cover
        return f"And({self.policies!r})"

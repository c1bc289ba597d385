"""Failure-domain-aware EC shard placement — the pure planning half of
the fleet-repair story (the policy layer `command_ec_common.go`'s balancedEcDistribution gestures at but never
enforces).

THE INVARIANT: no failure domain (rack, and transitively DC) may hold
MORE THAN `m` (parity count) shards of any one stripe. Losing one whole
domain then costs at most m shards, which a (k, m) code survives by
construction — "survive a node, then a rack" is exactly this inequality.
A 10+4 stripe therefore needs >= ceil(14/4) = 4 racks for a compliant
spread; on smaller topologies the planner degrades to MINIMIZING the
per-domain maximum (and `placement_violations` reports what remains, so
the gap is visible in `ec.status` instead of silent).

Everything here is pure data -> data (node dicts in, assignments out):
the shell's `ec.encode` spread, `ec.balance -fixPlacement` migration,
the master scheduler's rebuild-target choice, and the inline-ingest
parity spreader all call through these functions, so there is ONE
definition of "legal placement" in the tree.
"""

from __future__ import annotations

from typing import Optional, Sequence

#: legacy default domain cap — callers pass the volume's real parity
#: count; this is only the fallback when geometry is unknown (10+4).
DEFAULT_PARITY = 4


def domain_of(node: dict) -> tuple[str, str]:
    """One node's failure-domain identity: (data_center, rack). Rack is
    the enforcement granularity; the DC component keeps two same-named
    racks in different DCs distinct."""
    return (str(node.get("data_center", "")), str(node.get("rack", "")))


def max_per_domain(parity: int, override: int = 0) -> int:
    """The domain cap: `m` shards, unless an operator override
    (WEEDTPU_PLACEMENT_MAX_PER_DOMAIN, passed in parsed) tightens or
    loosens it. Never below 1 — a cap of 0 would make every placement
    infeasible."""
    cap = int(override) if override else int(parity)
    return max(1, cap)


def plan_spread(
    nodes: Sequence[dict],
    total: int,
    parity: int,
    *,
    cap_override: int = 0,
    load_of=None,
) -> dict[str, list[int]]:
    """Assign shard ids 0..total-1 to nodes, load-balanced AND
    domain-capped: each shard goes to the least-loaded node whose rack
    still has headroom under the cap; when NO rack has headroom (fewer
    racks than ceil(total/cap) — small topologies), the cap relaxes by
    one and assignment continues, i.e. the planner minimizes the
    per-domain maximum instead of failing. Deterministic (ties break on
    url) so tests and re-runs agree.

    `load_of(node) -> int` supplies each node's existing shard load for
    balancing (default: count of ec_shards entries' shard bits is the
    caller's business — 0 when absent)."""
    if not nodes:
        raise ValueError("no volume servers available")
    cap = max_per_domain(parity, cap_override)
    if load_of is None:
        load_of = lambda n: 0  # noqa: E731 — trivial default
    assigned: dict[str, list[int]] = {n["url"]: [] for n in nodes}
    base_load = {n["url"]: int(load_of(n)) for n in nodes}
    dom_count: dict[tuple, int] = {}
    eff_cap = cap
    for sid in range(total):
        viable = [n for n in nodes if dom_count.get(domain_of(n), 0) < eff_cap]
        while not viable:
            # fewer domains than the cap demands: relax one notch and
            # keep the spread as even as the topology allows
            eff_cap += 1
            viable = [
                n for n in nodes if dom_count.get(domain_of(n), 0) < eff_cap
            ]
        best = min(
            viable,
            key=lambda n: (
                len(assigned[n["url"]]) + base_load[n["url"]],
                dom_count.get(domain_of(n), 0),
                n["url"],
            ),
        )
        assigned[best["url"]].append(sid)
        dom_count[domain_of(best)] = dom_count.get(domain_of(best), 0) + 1
    return {u: s for u, s in assigned.items() if s}


def domain_shard_counts(
    holders: dict[int, Sequence[str]], domains: dict[str, tuple]
) -> dict[tuple, set[int]]:
    """{domain: set(shard ids present there)} for one stripe. A shard
    replicated inside one domain still counts ONCE — the invariant is
    about distinct stripe positions a domain failure removes, and a
    second copy of the same shard elsewhere keeps that position alive."""
    out: dict[tuple, set[int]] = {}
    for sid, urls in holders.items():
        for u in urls:
            dom = domains.get(u)
            if dom is None:
                continue
            out.setdefault(dom, set()).add(sid)
    # a shard ONLY held inside one domain is what that domain's failure
    # actually costs; shards replicated across domains survive. Keep the
    # conservative full count (presence), which upper-bounds the loss —
    # operators reading the audit want the worst case.
    return out


def stripe_violations(
    holders: dict[int, Sequence[str]],
    domains: dict[str, tuple],
    parity: int,
    cap_override: int = 0,
) -> list[tuple[tuple, list[int]]]:
    """Domains holding more than the cap's worth of one stripe's shards:
    [(domain, sorted shard ids)] — the positions whose ONLY copies live
    in the offending domain are the actual exposure, so shards that also
    exist elsewhere are excluded before comparing against the cap."""
    cap = max_per_domain(parity, cap_override)
    per_dom = domain_shard_counts(holders, domains)
    out: list[tuple[tuple, list[int]]] = []
    for dom, sids in sorted(per_dom.items()):
        exclusive = sorted(
            s
            for s in sids
            if not any(
                domains.get(u) is not None and domains[u] != dom
                for u in holders.get(s, ())
            )
        )
        if len(exclusive) > cap:
            out.append((dom, exclusive))
    return out


def domain_exposure(
    holders: dict[int, Sequence[str]], domains: dict[str, tuple]
) -> int:
    """The stripe's worst-case single-domain loss: how many shard
    positions the failure of its most-loaded domain would remove. The
    repair scheduler uses it as a ranking tiebreak — equal-redundancy
    stripes with higher exposure are one correlated failure closer to
    data loss."""
    per_dom = domain_shard_counts(holders, domains)
    worst = 0
    for dom, sids in per_dom.items():
        exclusive = sum(
            1
            for s in sids
            if not any(
                domains.get(u) is not None and domains[u] != dom
                for u in holders.get(s, ())
            )
        )
        worst = max(worst, exclusive)
    return worst


def pick_rebuild_target(
    nodes: Sequence[dict],
    holders: dict[int, Sequence[str]],
    domains: dict[str, tuple],
    missing: Sequence[int],
    parity: int,
    *,
    cap_override: int = 0,
    addr_of=None,
    strict: bool = False,
) -> Optional[dict]:
    """Choose the node a whole-stripe rebuild should land on. Rebuilt
    shards all materialize on the target, so the constraint is
    (shards the target's rack already holds) + |missing| <= cap;
    among compliant nodes prefer the one already holding the MOST of
    this stripe's shards (fewest survivor slabs over the wire), then
    the least EC-loaded, then url. Falls back to the least-loaded
    compliant-less node when no rack has headroom (small topologies) —
    repairing with a violation beats not repairing — unless `strict`,
    which returns None instead of violating (used when probing whether
    a SPECIFIC node can legally join a batch; the caller has other
    candidates, so there is no repair-or-nothing tradeoff).

    `addr_of(node) -> str` maps a node dict to the url key used in
    `holders` (defaults to node["url"])."""
    if not nodes:
        return None
    if addr_of is None:
        addr_of = lambda n: n["url"]  # noqa: E731
    cap = max_per_domain(parity, cap_override)
    per_dom = domain_shard_counts(holders, domains)

    def local_shards(n: dict) -> int:
        u = addr_of(n)
        return sum(1 for sids in holders.values() for h in sids if h == u)

    def key(n: dict):
        # most of THIS stripe's shards first (fewest survivor slabs over
        # the wire), then the node's cluster-wide EC load when the caller
        # supplies it (`ec_load` on the node dict), then url
        return (-local_shards(n), int(n.get("ec_load", 0)), n["url"])

    compliant = [
        n
        for n in nodes
        if len(per_dom.get(domain_of(n), set()) | set(missing)) <= cap
    ]
    if strict and not compliant:
        return None
    pool = compliant or list(nodes)
    return min(pool, key=key)


def plan_parity_targets(
    nodes: Sequence[dict],
    owner_url: str,
    data_shards: int,
    total_shards: int,
    *,
    cap_override: int = 0,
    load_of=None,
) -> dict[int, dict]:
    """Inline-ingest spread plan: which node should host each PARITY
    shard of a volume being encoded on `owner_url`. The owner keeps the
    k data shards (they are views of its local .dat), so parity rows
    stream to nodes OUTSIDE the owner's domain first, spread so no
    other domain accumulates more than the cap. Returns
    {parity shard id: node dict} — possibly empty (single-node cluster:
    nothing to spread to, seal keeps everything local)."""
    parity = total_shards - data_shards
    others = [n for n in nodes if n["url"] != owner_url]
    if not others or parity <= 0:
        return {}
    owner_dom = next(
        (domain_of(n) for n in nodes if n["url"] == owner_url), None
    )
    # prefer non-owner-domain nodes; same-domain nodes only when there is
    # nowhere else (still better than the owner hosting all 14)
    preferred = [n for n in others if domain_of(n) != owner_dom] or others
    alloc = plan_spread(
        preferred,
        parity,
        parity,
        cap_override=cap_override,
        load_of=load_of,
    )
    by_url = {n["url"]: n for n in preferred}
    out: dict[int, dict] = {}
    for url, sids in alloc.items():
        for rel in sids:
            out[data_shards + rel] = by_url[url]
    return out

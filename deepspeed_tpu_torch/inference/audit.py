"""PoolAuditor: online invariant checking and repair for the paged KV pool
(counterpart of `deepspeed_tpu/inference/audit.py`; stdlib only).

The serving engine's host-side bookkeeping — the allocator's free list and
refcounts, the prefix cache's hash chains, each slot's block table — is
plain Python state mutated a few times a scheduler sync. A missed decref,
a double free or a stale hash entry crashes nothing: it leaks capacity,
lets two slots write one block, or serves evicted K/V to a later prefix
hit. Every block's ownership is recorded several times over, and the
invariants say how those copies must agree:

  I1  free/referenced disjoint: no block is both on the free list and
      refcounted;
  I2  refcount truth: a block's refcount equals the number of slot
      references to it; a refcount-0 block is parked on the reclaimable
      LRU;
  I3  hash-chain liveness: every registered hash points at a block the
      allocator still tracks, and the hash<->block maps are inverse
      bijections;
  I4  trash sanctity: block 0 is never free-listed, refcounted,
      slot-referenced or registered;
  I5  no leaks: every usable block is free or tracked by the refcounts;
  I6  table fidelity: each active slot's table row equals its host block
      list (padded with trash), and FREE slots point every entry at trash.

The checks are pure reads of host state (the tables the step functions
are handed are host arrays, copied into the snapshot once an audit, never
in the step loop). On a violation the engine either repairs — the slot
tables are the ground truth, since they are what the step functions read,
so the free list, refcounts and reclaimable LRU are rebuilt from them — or
raises `PoolCorruptionError`. `audit_state_dict` runs the same checks on a
JSON dump of `audit_state()` (`audit_main`, the offline form).
"""

import collections
import dataclasses
import json
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.inference.kv_cache import TRASH_BLOCK

__all__ = ["AuditReport", "PoolAuditor", "PoolCorruptionError",
           "Violation", "audit_main"]

# the invariant classes a report buckets violations into (I1..I6 above)
VIOLATION_KINDS = ("free_referenced", "free_list_corrupt", "refcount_drift",
                   "stale_hash", "trash_referenced", "leak",
                   "table_mismatch", "reclaimable_corrupt")


class PoolCorruptionError(RuntimeError):
    """The pool's host-side bookkeeping failed its invariant audit and the
    engine is configured not to self-repair (`serving.audit_action`).
    Raised out of `ServingEngine.step()` so the serving router's existing
    failover path quarantines the replica like any other step failure."""

    def __init__(self, report: "AuditReport"):
        self.report = report
        super().__init__(f"KV-pool audit failed: {report.summary()}")


@dataclasses.dataclass
class Violation:
    kind: str                 # one of VIOLATION_KINDS
    block: Optional[int]      # offending physical block (None for structural)
    detail: str

    def to_dict(self):
        return {"kind": self.kind, "block": self.block, "detail": self.detail}


class AuditReport:
    """Outcome of one audit pass: violations bucketed by invariant class."""

    def __init__(self, violations: List[Violation], checked_blocks: int,
                 checked_slots: int):
        self.violations = violations
        self.checked_blocks = checked_blocks
        self.checked_slots = checked_slots

    @property
    def ok(self) -> bool:
        return not self.violations

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.violations:
            out[v.kind] = out.get(v.kind, 0) + 1
        return out

    def summary(self) -> str:
        if self.ok:
            return (f"clean ({self.checked_blocks} blocks, "
                    f"{self.checked_slots} active slots)")
        kinds = ", ".join(f"{k}={n}" for k, n in sorted(self.by_kind().items()))
        return f"{len(self.violations)} violations ({kinds})"

    def to_dict(self):
        return {"ok": self.ok, "checked_blocks": self.checked_blocks,
                "checked_slots": self.checked_slots,
                "by_kind": self.by_kind(),
                "violations": [v.to_dict() for v in self.violations]}


def _state_from_engine(engine) -> Dict[str, Any]:
    """Snapshot the host-side pool bookkeeping into the portable audit-state
    dict (all-JSON types — the interchange format `audit_main` reads)."""
    alloc = engine.allocator
    slots = []
    for s in engine.slots:
        if s.state == 0:                           # _FREE
            continue
        slots.append({"idx": s.idx, "uid": str(s.uid), "state": int(s.state),
                      "blocks": [int(b) for b in s.blocks]})
    registered, rev = {}, {}
    if engine.prefix_cache is not None:
        registered = engine.prefix_cache.snapshot()
        rev = engine.prefix_cache.reverse_snapshot()
    return {
        "num_blocks": int(alloc.num_blocks),
        "policy": alloc.policy,
        "free": [int(b) for b in alloc._free],
        "free_set": sorted(int(b) for b in alloc._free_set),
        "refs": {str(b): int(c) for b, c in alloc._refs.items()},
        "reclaimable": [int(b) for b in alloc._reclaimable],
        "registered": registered,          # hash hex -> block
        "registered_rev": rev,             # block -> hash hex
        "slots": slots,
        "tables": [[int(b) for b in row] for row in engine.tables],
    }


def audit_state_dict(state: Dict[str, Any]) -> AuditReport:
    """Run every invariant over a portable audit-state dict (live snapshot
    or a JSON dump). Pure function — never mutates the state."""
    bad: List[Violation] = []
    n = int(state["num_blocks"])
    free = [int(b) for b in state["free"]]
    free_set = set(int(b) for b in state.get("free_set", free))
    refs = {int(b): int(c) for b, c in state["refs"].items()}
    reclaimable = [int(b) for b in state.get("reclaimable", ())]
    registered = {h: int(b) for h, b in state.get("registered", {}).items()}
    registered_rev = {int(b): h
                      for b, h in state.get("registered_rev", {}).items()}
    slots = state.get("slots", [])
    tables = state.get("tables")

    # I1 + free-list structure: duplicates, shadow-set drift, range
    seen = set()
    for b in free:
        if b in seen:
            bad.append(Violation("free_list_corrupt", b,
                                 f"block {b} appears twice on the free list"))
        seen.add(b)
        if not (0 < b < n):
            bad.append(Violation("free_list_corrupt", b,
                                 f"free-listed block {b} outside pool "
                                 f"[1, {n})"))
    if seen != free_set:
        drift = sorted(seen.symmetric_difference(free_set))
        bad.append(Violation("free_list_corrupt", None,
                             f"free list / shadow set disagree on blocks "
                             f"{drift[:8]}"))
    for b in sorted(seen & set(refs)):
        bad.append(Violation("free_referenced", b,
                             f"block {b} is on the free list AND refcounted "
                             f"({refs[b]}) — it will be reallocated under a "
                             f"live reader"))

    # I2: refcount truth against the slot tables (ground truth)
    slot_refs: Dict[int, int] = {}
    for s in slots:
        for b in s["blocks"]:
            slot_refs[int(b)] = slot_refs.get(int(b), 0) + 1
    for b in sorted(set(refs) | set(slot_refs)):
        if b == TRASH_BLOCK:
            continue                                   # I4 reports it
        expect = slot_refs.get(b, 0)
        actual = refs.get(b)
        if actual is None:
            bad.append(Violation("refcount_drift", b,
                                 f"block {b} referenced by {expect} slot(s) "
                                 f"but unknown to the allocator"))
        elif actual != expect:
            if expect == 0 and b in reclaimable:
                pass                                   # parked: refcount 0 ok
            else:
                bad.append(Violation(
                    "refcount_drift", b,
                    f"block {b}: refcount {actual} != {expect} slot "
                    f"reference(s)"))
        if actual == 0 and b not in reclaimable:
            bad.append(Violation("refcount_drift", b,
                                 f"block {b}: refcount 0 but not parked on "
                                 f"the reclaimable list"))

    # reclaimable structure: refcount-0 registered blocks only, never free
    reclaim_seen = set()
    for b in reclaimable:
        if b in reclaim_seen:
            bad.append(Violation("reclaimable_corrupt", b,
                                 f"block {b} parked twice on the "
                                 f"reclaimable list"))
        reclaim_seen.add(b)
        if refs.get(b, None) != 0:
            bad.append(Violation("reclaimable_corrupt", b,
                                 f"reclaimable block {b} has refcount "
                                 f"{refs.get(b)!r} (must be exactly 0)"))
        if b in free_set:
            bad.append(Violation("reclaimable_corrupt", b,
                                 f"block {b} is both reclaimable and free"))

    # I3: hash-chain liveness + bijection
    for h, b in sorted(registered.items()):
        if b not in refs:
            bad.append(Violation("stale_hash", b,
                                 f"hash {h[:12]}… registered to block {b}, "
                                 f"which the allocator no longer tracks"))
        if registered_rev.get(b) != h:
            bad.append(Violation("stale_hash", b,
                                 f"hash {h[:12]}… -> block {b} has no "
                                 f"matching reverse entry"))
    for b, h in sorted(registered_rev.items()):
        if registered.get(h) != b:
            bad.append(Violation("stale_hash", b,
                                 f"block {b} -> hash {h[:12]}… has no "
                                 f"matching forward entry"))

    # I4: trash sanctity
    if TRASH_BLOCK in free_set:
        bad.append(Violation("trash_referenced", TRASH_BLOCK,
                             "trash block 0 is on the free list"))
    if TRASH_BLOCK in refs:
        bad.append(Violation("trash_referenced", TRASH_BLOCK,
                             "trash block 0 is refcounted"))
    if TRASH_BLOCK in slot_refs:
        bad.append(Violation("trash_referenced", TRASH_BLOCK,
                             "trash block 0 appears in a slot's block list"))
    if TRASH_BLOCK in registered_rev:
        bad.append(Violation("trash_referenced", TRASH_BLOCK,
                             "trash block 0 is registered in the prefix "
                             "cache"))

    # I5: no leaks — every usable block is free or tracked
    for b in range(1, n):
        if b not in free_set and b not in refs:
            bad.append(Violation("leak", b,
                                 f"block {b} is neither free nor tracked — "
                                 f"unreachable forever"))

    # I6: device-visible tables mirror the host block lists
    if tables is not None:
        active = {s["idx"]: s for s in slots}
        for idx, row in enumerate(tables):
            s = active.get(idx)
            if s is None:
                if any(int(b) != TRASH_BLOCK for b in row):
                    bad.append(Violation(
                        "table_mismatch", None,
                        f"free slot {idx}'s table row references non-trash "
                        f"blocks"))
                continue
            blocks = [int(b) for b in s["blocks"]]
            head = [int(b) for b in row[:len(blocks)]]
            if head != blocks:
                bad.append(Violation(
                    "table_mismatch", None,
                    f"slot {idx} (uid {s['uid']}): table row {head[:8]} != "
                    f"host blocks {blocks[:8]}"))
            if any(int(b) != TRASH_BLOCK for b in row[len(blocks):]):
                bad.append(Violation(
                    "table_mismatch", None,
                    f"slot {idx} (uid {s['uid']}): table tail past the "
                    f"block list is not all trash"))

    return AuditReport(bad, checked_blocks=n, checked_slots=len(slots))


class PoolAuditor:
    """Invariant checker + repairer bound to a live `ServingEngine`.

    `audit()` snapshots the host bookkeeping and checks I1..I6;
    `repair()` rebuilds the allocator's refcounts, reclaimable LRU, and
    free list from the slot tables (the state the compiled programs
    actually consume — the only copy that cannot be wrong about what the
    device will read/write next step) and re-syncs the device-visible
    table rows and prefix-cache maps to match."""

    def __init__(self, engine):
        self.engine = engine

    def snapshot(self) -> Dict[str, Any]:
        return _state_from_engine(self.engine)

    def audit(self) -> AuditReport:
        return audit_state_dict(self.snapshot())

    def repair(self) -> Dict[str, Any]:
        """Rebuild from ground truth. Returns a summary of what changed.

        Policy on ambiguous blocks: a registered (content-hashed) block no
        slot references parks refcount-0 on the reclaimable LRU — its KV
        content is assumed intact, and a wrong assumption costs only a
        future cache miss, never wrong tokens (eviction unregisters it
        before reuse). A hash entry pointing at a slot-referenced block is
        kept (registration of live shared blocks is the normal state). A
        block in no slot and no registry goes back to the free list."""
        eng = self.engine
        alloc = eng.allocator
        before = self.audit()

        slot_refs: Dict[int, int] = {}
        for s in eng.slots:
            if s.state == 0:                           # _FREE
                continue
            for b in s.blocks:
                if b == TRASH_BLOCK:
                    continue
                slot_refs[int(b)] = slot_refs.get(int(b), 0) + 1

        pc = eng.prefix_cache
        if pc is not None:
            # re-derive a consistent bijection: forward map wins, entries
            # pointing at the trash block or out-of-range blocks drop
            fwd = {h: b for h, b in pc._by_hash.items()
                   if 0 < int(b) < alloc.num_blocks}
            pc._by_hash.clear()
            pc._by_block.clear()
            for h, b in fwd.items():
                if b in pc._by_block:                  # two hashes, one block
                    continue
                pc._by_hash[h] = b
                pc._by_block[b] = h
            registered = set(pc._by_block)
        else:
            registered = set()

        new_refs: Dict[int, int] = dict(slot_refs)
        new_reclaim: "Dict[int, None]" = {}
        if alloc.policy == "lru":
            # preserve the surviving LRU order, then adopt any registered
            # block that lost its parking spot (appended newest — they were
            # live a moment ago)
            for b in alloc._reclaimable:
                if b in registered and b not in new_refs:
                    new_reclaim[b] = None
                    new_refs[b] = 0
            for b in sorted(registered):
                if b not in new_refs:
                    new_reclaim[b] = None
                    new_refs[b] = 0
        elif pc is not None:
            # policy "none": nothing parks; unregister orphaned hashes
            for b in sorted(registered):
                if b not in new_refs:
                    pc._unregister_block(b)

        alloc._refs = new_refs
        alloc._reclaimable = collections.OrderedDict(new_reclaim)
        # descending ids so pop() keeps yielding low ids first (the
        # allocator's deterministic-order contract)
        alloc._free = [b for b in range(alloc.num_blocks - 1, 0, -1)
                       if b not in new_refs]
        alloc._free_set = set(alloc._free)

        # re-sync the device-visible table rows to the host block lists
        for s in eng.slots:
            eng.tables[s.idx, :] = TRASH_BLOCK
            if s.state != 0 and s.blocks:
                eng.tables[s.idx, :len(s.blocks)] = s.blocks

        after = self.audit()
        return {"violations_before": len(before.violations),
                "violations_after": len(after.violations),
                "by_kind": before.by_kind(),
                "rebuilt_refs": len(new_refs),
                "rebuilt_free": len(alloc._free),
                "reclaimable": len(new_reclaim),
                "clean": after.ok}


# ----------------------------------------------------------------------
# CLI: `audit_main`
# ----------------------------------------------------------------------


def _find_audit_states(doc, path="$"):
    """Recursively locate audit-state dicts inside an arbitrary JSON
    document — a raw `audit_state()` snapshot, a flight-recorder dump whose
    state carries `audit_state`, or a router dump with per-replica
    states."""
    found = []
    if isinstance(doc, dict):
        if "num_blocks" in doc and "refs" in doc and "free" in doc:
            return [(path, doc)]
        for k, v in doc.items():
            found.extend(_find_audit_states(v, f"{path}.{k}"))
    elif isinstance(doc, list):
        for i, v in enumerate(doc):
            found.extend(_find_audit_states(v, f"{path}[{i}]"))
    return found


def audit_main(argv=None) -> int:
    """Audit one or more dumped pool states (the JAX package's
    `bin/dstpu_audit`, as a function).
    Exit code 0 = every state clean, 1 = violations found, 2 = no audit
    state located in the input."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="dstpu_audit",
        description="Run the KV-pool invariant auditor (inference/audit.py) "
                    "against a dumped engine state: a raw audit_state() "
                    "snapshot, or a flight-recorder .flightrec.NNN.json "
                    "dump containing one.")
    ap.add_argument("path", help="JSON file to audit")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)

    with open(args.path) as f:
        doc = json.load(f)
    states = _find_audit_states(doc)
    if not states:
        print(f"dstpu_audit: no audit state found in {args.path} "
              f"(expected an audit_state() snapshot or a flight dump "
              f"containing one)")
        return 2

    reports = [(where, audit_state_dict(state)) for where, state in states]
    if args.json:
        print(json.dumps({"path": args.path,
                          "states": [{"at": where, **rep.to_dict()}
                                     for where, rep in reports]}, indent=1))
    else:
        for where, rep in reports:
            print(f"{where}: {rep.summary()}")
            for v in rep.violations:
                print(f"  [{v.kind}] block={v.block}: {v.detail}")
    return 0 if all(rep.ok for _, rep in reports) else 1

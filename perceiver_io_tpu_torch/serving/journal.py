"""The write-ahead request journal for engine crash recovery (counterpart of
``perceiver_io_tpu/serving/journal.py``, kept as the port's own copy).

The continuous-batching engine (``serving.engine``) can die mid-decode —
OOM-killed, preempted, segfaulted — and nothing in the event stream is
*authoritative* about which requests still owe tokens: ``events.jsonl`` is
telemetry (deactivates on a dead filesystem, never read back by the
server). :class:`RequestJournal` is the durable half: an append-only JSONL
ledger, one record per accounting transition, with the ``events.jsonl``
hygiene (strict JSON — NaN/Inf become null; one ``write`` per append so a
crash tears at most the final line; torn tails tolerated on read):

- ``submitted`` — WRITE-AHEAD, before admission runs: the full request
  identity (prompt token ids, decode budget, rng seed, deadline) so a fresh
  engine can reconstruct the ``RequestSpec`` verbatim;
- ``admitted`` — the request passed admission (a shed writes ``terminal``
  instead);
- ``progress`` — token ids emitted since the previous progress record
  (appended after each join/engine step, so replay concatenates them into
  the exact served stream);
- ``evict`` / ``resume`` / ``recovered`` — the preemption audit trail
  (not needed for correctness: a parked request is simply non-terminal);
- ``terminal`` — exactly one per finished request
  (``ok | error | timeout | shed | cancelled``).

Recovery (``EngineFrontEnd.recover``) replays the journal: every submitted
index without a terminal record is re-admitted and resumed **token-exactly**
by prefill replay over ``prompt + journaled progress tokens`` with the
request's generator advanced one draw per journaled token when sampling
(``generation.advance_generator``). Delivery is at-least-once: tokens the
dead engine emitted after its last ``progress`` append are re-emitted by
the replay — :meth:`RequestJournal.replay`'s concatenated token streams are
therefore exactly the uninterrupted run's streams
(``tests/test_torch_evict.py`` pins this, greedy and temperature).

Books balance ACROSS the restart: both engine incarnations append to the
same file, so :meth:`books`/:meth:`audit` close over the union —
``submitted == terminal`` by request index once the recovered engine
drains.

Fleet failover (the JAX package's ``serving/router.py``) adds a second
recovery shape: the dead replica's journal is replayed onto a SURVIVOR that
keeps its own journal. The survivor re-journals each adopted request into its
own file (where its terminal record will land), and the dead journal gets
a ``recovered`` record with ``handoff`` naming the survivor — a handed-off
entry counts as CLOSED in the dead journal's :meth:`books`/:meth:`audit`
(its terminal outcome lives in the survivor's ledger) and is excluded from
:meth:`pending` so a third replay cannot double-adopt it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

JOURNAL_SCHEMA_VERSION = 1

# journal record kinds (the closed vocabulary audit() enforces)
JOURNAL_KINDS = (
    "submitted", "admitted", "progress", "evict", "resume", "recovered",
    "terminal",
)


class JournalEntry:
    """Replayed per-request state: the spec identity, the concatenated
    progress tokens, and the terminal outcome (None = still owed)."""

    __slots__ = (
        "index", "prompt_len", "max_new_tokens", "input_ids", "rng_seed",
        "deadline_s", "tenant", "admitted", "tokens", "terminal",
        "evictions", "recovered", "handoff",
    )

    def __init__(self, index: int):
        self.index = index
        self.prompt_len: Optional[int] = None
        self.max_new_tokens: Optional[int] = None
        self.input_ids: Optional[list] = None
        self.rng_seed: Optional[int] = None
        self.deadline_s: Optional[float] = None
        self.tenant: Optional[str] = None
        self.admitted = False
        self.tokens: List[int] = []
        self.terminal: Optional[str] = None
        self.evictions = 0
        self.recovered = False
        # set when a fleet failover handed this request to another replica's
        # journal (the survivor's id): closed HERE, terminal THERE
        self.handoff: Optional[str] = None

    def spec(self):
        """The reconstructed ``obs.loadgen.RequestSpec`` (numpy prompt)."""
        import numpy as np

        from perceiver_io_tpu_torch.obs.loadgen import RequestSpec

        return RequestSpec(
            index=self.index,
            prompt_len=int(self.prompt_len),
            max_new_tokens=int(self.max_new_tokens),
            input_ids=np.asarray(self.input_ids, np.int32),
            rng_seed=int(self.rng_seed),
            tenant=self.tenant,
        )


def _nan_to_none(obj):
    from perceiver_io_tpu_torch.obs.events import _nan_to_none as impl

    return impl(obj)


class RequestJournal:
    """Append-only JSONL request ledger (see module docstring).

    Opening an existing path CONTINUES it — that is the recovery contract:
    the fresh engine journals its terminal records into the same file the
    dead engine's submissions live in, and the combined books balance.
    Unlike ``EventLog`` a failed journal write RAISES (the journal is the
    durability guarantee, not telemetry — serving blind is worse than
    failing loudly).
    """

    def __init__(self, path: str):
        self.path = os.path.abspath(str(path))
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    # -- writing -------------------------------------------------------------

    def append(self, kind: str, index: int, **fields) -> None:
        if kind not in JOURNAL_KINDS:
            raise ValueError(f"unknown journal record kind {kind!r}")
        row = {
            "ts": round(time.time(), 6),
            "kind": kind,
            "index": int(index),
            "schema_version": JOURNAL_SCHEMA_VERSION,
        }
        row.update(fields)
        try:
            line = json.dumps(row, default=str, allow_nan=False)
        except ValueError:
            line = json.dumps(_nan_to_none(row), default=str, allow_nan=False)
        # one write per record: a crash tears at most the final line, and
        # the reader tolerates exactly that
        with open(self.path, "a") as f:
            f.write(line + "\n")

    # -- reading -------------------------------------------------------------

    def _read(self):
        """One pass over the file: ``(parsed rows, torn-line problems)``.
        A torn TAIL line is the tolerated crash artifact (no problem
        recorded); a torn MID-file line is reported — every reader below
        shares this single parse."""
        if not os.path.exists(self.path):
            return [], []
        with open(self.path) as f:
            lines = [ln for ln in (l.strip() for l in f) if ln]
        out: List[Dict] = []
        problems: List[str] = []
        for i, line in enumerate(lines):
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                if i < len(lines) - 1:
                    problems.append(f"journal line {i + 1}: unparseable mid-file")
                continue
            if isinstance(row, dict):
                out.append(row)
        return out, problems

    def rows(self) -> List[Dict]:
        """Parsed records in append order; a torn tail line (the crash) is
        skipped, torn lines elsewhere too (audit() complains, not the
        reader — the ``events.jsonl`` discipline)."""
        return self._read()[0]

    def replay(self, rows: Optional[List[Dict]] = None) -> Dict[int, JournalEntry]:
        """Per-request state folded over the journal, keyed by request
        index, in first-submission order (dicts preserve insertion order).
        ``entry.tokens`` is the concatenation of every progress record —
        the exact served stream (see module docstring on at-least-once).
        ``rows`` lets a caller that already parsed the file skip the
        re-read (audit()/books() share one parse)."""
        state: Dict[int, JournalEntry] = {}
        for row in (self.rows() if rows is None else rows):
            idx = row.get("index")
            if not isinstance(idx, int):
                continue
            entry = state.setdefault(idx, JournalEntry(idx))
            kind = row.get("kind")
            if kind == "submitted":
                entry.prompt_len = row.get("prompt_len")
                entry.max_new_tokens = row.get("max_new_tokens")
                entry.input_ids = row.get("input_ids")
                entry.rng_seed = row.get("rng_seed")
                entry.deadline_s = row.get("deadline_s")
                entry.tenant = row.get("tenant")
            elif kind == "admitted":
                entry.admitted = True
            elif kind == "progress":
                entry.tokens.extend(int(t) for t in row.get("tokens", ()))
            elif kind == "evict":
                entry.evictions += 1
            elif kind == "recovered":
                entry.recovered = True
                handoff = row.get("handoff")
                if handoff is not None:
                    entry.handoff = str(handoff)
            elif kind == "terminal":
                entry.terminal = row.get("outcome")
        return state

    def pending(self) -> List[JournalEntry]:
        """Submitted-but-not-terminal entries (what recover() re-admits),
        in first-submission order. An entry whose ``submitted`` record was
        torn/unparseable (no spec identity to rebuild) is EXCLUDED — it
        cannot be recovered, and :meth:`audit` reports it rather than
        recover() dying mid-way and taking the intact requests with it.
        A handed-off entry (fleet failover already adopted it elsewhere)
        is likewise excluded — replaying this journal a second time onto
        yet another replica must not double-adopt."""
        return [
            e for e in self.replay().values()
            if e.terminal is None and e.prompt_len is not None
            and e.handoff is None
        ]

    # -- the books across the restart ---------------------------------------

    def books(self) -> Dict:
        """The cross-incarnation accounting identity: unique submitted
        indices vs unique terminal indices. ``balanced`` means every
        submitted request has reached exactly one terminal outcome —
        checked AFTER the recovered engine drains, it holds across the
        crash."""
        state = self.replay()
        submitted = [e.index for e in state.values() if e.prompt_len is not None]
        terminal = [e.index for e in state.values() if e.terminal is not None]
        # a handed-off request is closed in THIS ledger (its terminal
        # outcome lives in the adopting replica's journal)
        closed = [
            e.index for e in state.values()
            if e.terminal is not None or e.handoff is not None
        ]
        outcomes: Dict[str, int] = {}
        for e in state.values():
            if e.terminal is not None:
                outcomes[e.terminal] = outcomes.get(e.terminal, 0) + 1
        return {
            "submitted": len(submitted),
            "terminal": len(terminal),
            "pending": len(submitted) - len(closed),
            "recovered": sum(1 for e in state.values() if e.recovered),
            "handed_off": sum(1 for e in state.values() if e.handoff is not None),
            "evictions": sum(e.evictions for e in state.values()),
            "outcomes": outcomes,
            "balanced": set(submitted) == set(closed),
        }

    def audit(self) -> List[str]:
        """Journal-integrity problems (empty = clean books across the
        restart): every submitted request terminal exactly once, no
        terminal without a submission, no double-terminal, progress within
        budget, no mid-file torn lines."""
        rows, torn = self._read()  # ONE file pass feeds every check below
        problems: List[str] = []
        terminal_counts: Dict[int, int] = {}
        state = self.replay(rows)
        for row in rows:
            if row.get("kind") == "terminal":
                idx = row.get("index")
                terminal_counts[idx] = terminal_counts.get(idx, 0) + 1
        for idx, n in sorted(terminal_counts.items()):
            if n > 1:
                problems.append(f"request {idx}: {n} terminal records (want exactly 1)")
            if idx not in state or state[idx].prompt_len is None:
                problems.append(f"request {idx}: terminal without a submitted record")
        for e in state.values():
            if e.terminal is None and e.handoff is not None:
                # fleet failover closed this entry here: its terminal
                # outcome is owed by (and audited in) the adopting
                # replica's journal, not this one
                continue
            if e.terminal is None:
                if e.prompt_len is None:
                    # progress/admitted rows whose submitted record was torn
                    # away: pending() skips these (no spec to rebuild), so
                    # the loss MUST surface here or nowhere
                    problems.append(
                        f"request {e.index}: records without a parseable "
                        f"submitted record — unrecoverable "
                        f"({len(e.tokens)} token(s) journaled)"
                    )
                else:
                    problems.append(
                        f"request {e.index}: submitted but never terminal "
                        f"({len(e.tokens)} token(s) journaled)"
                    )
            if e.max_new_tokens is not None and len(e.tokens) > e.max_new_tokens:
                problems.append(
                    f"request {e.index}: {len(e.tokens)} progress tokens exceed "
                    f"budget {e.max_new_tokens}"
                )
        problems.extend(torn)
        return problems

"""Per-validator observability: attestation/block hit tracking + reporting.

The port of `lighthouse_tpu/beacon_chain/validator_monitor.py`.

Role of the reference's `validator_monitor`
(beacon_node/beacon_chain/src/validator_monitor.rs — a full subsystem:
registered validators get per-epoch hit/miss/delay tracking, missed-
proposal detection, and per-epoch summaries through logs and metrics).

Feeding: the chain calls `register_block` on every import (crediting
registered attesters and the proposer) and `advance` on every slot
tick. When an epoch COMPLETES — attestations for epoch `e` can be
included through epoch `e+1`, so `e` closes once the clock reaches
`e+2` — the monitor emits one `validator_summary` event into the
node's lifecycle journal (common/events_journal.py) and refreshes the
``lighthouse_tpu_validator_monitor_stat{stat}`` gauges, so both the
forensic plane (`GET /lighthouse/events?kind=validator_summary`) and
the scrape carry the same inclusion/miss/proposal numbers. Expected
proposals come from the chain's proposer cache (`proposers_fn`), so a
registered key that SHOULD have proposed but produced no imported
block is reported as a missed proposal.
"""

from collections import defaultdict

from lighthouse_tpu_torch.common.events_journal import JOURNAL
from lighthouse_tpu_torch.common.metrics import REGISTRY

HISTORIC_EPOCHS = 4

_MONITOR_STAT = REGISTRY.gauge_vec(
    "lighthouse_tpu_validator_monitor_stat",
    "validator-monitor statistics for the last COMPLETED epoch "
    "(registered, hits, misses, proposals, missed_proposals)",
    ("stat",),
)


class ValidatorMonitor:
    def __init__(self, registered=(), journal=None):
        self.registered = set(registered)
        self.journal = journal if journal is not None else JOURNAL
        # epoch -> validator -> {"attested": bool, "delay": int}
        self._epochs: dict[int, dict] = defaultdict(dict)
        self._proposals: dict[int, list] = defaultdict(list)
        # epoch -> [slots a registered validator was EXPECTED to propose]
        self._expected_proposals: dict[int, list] = {}
        self._reported_through = -1  # highest epoch already summarized
        self.last_summary: dict | None = None

    def register(self, *indices):
        self.registered.update(indices)

    def auto_register_all(self, n: int):
        self.registered.update(range(n))

    # ------------------------------------------------------------ feeding

    def register_block(self, block, indexed_attestations, spec):
        """Feed an imported block: credits attesters and the proposer."""
        epoch = spec.slot_to_epoch(block.slot)
        if block.proposer_index in self.registered:
            self._proposals[epoch].append(int(block.proposer_index))
        for indexed in indexed_attestations:
            att_epoch = indexed.data.target.epoch
            delay = block.slot - indexed.data.slot
            for v in indexed.attesting_indices:
                if v not in self.registered:
                    continue
                rec = self._epochs[att_epoch].setdefault(
                    v, {"attested": False, "delay": None}
                )
                rec["attested"] = True
                if rec["delay"] is None or delay < rec["delay"]:
                    rec["delay"] = delay

    def _first_data_epoch(self):
        keys = list(self._epochs) + list(self._proposals)
        return min(keys) if keys else None

    def advance(self, current_epoch: int, proposers_fn=None):
        """Clock tick: close out every epoch that can no longer gain
        inclusions (epoch e closes at current_epoch >= e + 2), emit its
        `validator_summary` journal event, refresh the monitor gauges,
        and prune the historic window. `proposers_fn(epoch)` supplies
        the epoch's expected proposer per slot (the chain's proposer
        cache) for missed-proposal detection. No-op without registered
        keys — an unmonitored node pays nothing.

        Two guards keep late registration honest: catch-up is bounded
        at the HISTORIC window (never an O(E) back-fill stalling one
        slot tick on per-epoch proposer computations), and epochs
        BEFORE the first recorded observation report as 'unmonitored'
        — no data was being collected, so an all-miss/all-missed-
        proposal 'degraded' verdict there would be a false alarm."""
        if not self.registered:
            return
        start = max(
            self._reported_through + 1,
            current_epoch - 1 - HISTORIC_EPOCHS,
            0,
        )
        first_data = self._first_data_epoch()
        for epoch in range(start, current_epoch - 1):
            self._reported_through = epoch
            if first_data is None or epoch < first_data:
                self.journal.emit(
                    "validator_summary",
                    outcome="unmonitored",
                    epoch=epoch,
                )
                continue
            if proposers_fn is not None and (
                epoch not in self._expected_proposals
            ):
                try:
                    self._expected_proposals[epoch] = [
                        i
                        for i in proposers_fn(epoch)
                        if i in self.registered
                    ]
                # lint: allow(except-swallow): shuffle unavailable
                except Exception:
                    # proposer shuffle unavailable (pruned state on a
                    # checkpoint-synced node): report without it —
                    # expected on checkpoint-synced nodes, not an error
                    self._expected_proposals[epoch] = []
            summary = self.epoch_summary(epoch)
            self.last_summary = summary
            self.journal.emit(
                "validator_summary",
                slot=None,
                outcome=(
                    "ok" if summary["misses"] == 0
                    and summary["missed_proposals"] == 0
                    else "degraded"
                ),
                **{
                    k: summary[k]
                    for k in (
                        "epoch", "hits", "misses", "proposals",
                        "expected_proposals", "missed_proposals",
                    )
                },
            )
            for stat in (
                "hits", "misses", "proposals", "missed_proposals"
            ):
                _MONITOR_STAT.labels(stat).set(summary[stat])
            _MONITOR_STAT.labels("registered").set(len(self.registered))
        self.prune(current_epoch)

    def prune(self, current_epoch: int):
        cutoff = current_epoch - HISTORIC_EPOCHS
        for store in (
            self._epochs, self._proposals, self._expected_proposals
        ):
            for e in [e for e in store if e < cutoff]:
                del store[e]

    # ------------------------------------------------------------ queries

    def epoch_summary(self, epoch: int):
        recs = self._epochs.get(epoch, {})
        hits = [v for v in self.registered if recs.get(v, {}).get("attested")]
        misses = [v for v in self.registered if v not in recs]
        delays = [
            recs[v]["delay"] for v in hits if recs[v]["delay"] is not None
        ]
        made = self._proposals.get(epoch, [])
        expected = self._expected_proposals.get(epoch, [])
        # multiset diff: a validator can propose more than once per epoch
        remaining = list(made)
        missed_proposals = 0
        for idx in expected:
            if idx in remaining:
                remaining.remove(idx)
            else:
                missed_proposals += 1
        return {
            "epoch": epoch,
            "hits": len(hits),
            "misses": len(misses),
            "missed_validators": sorted(misses)[:16],
            "mean_inclusion_delay": (
                sum(delays) / len(delays) if delays else None
            ),
            "proposals": len(made),
            "expected_proposals": len(expected),
            "missed_proposals": missed_proposals,
        }

    def health_summary(self) -> dict:
        """The /lighthouse/health `validator_monitor` section."""
        return {
            "registered": len(self.registered),
            "reported_through_epoch": self._reported_through,
            "last_summary": self.last_summary,
        }

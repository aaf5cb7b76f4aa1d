"""repro_torch.obs: declarative SLOs over host-side stats.

Port of the ``slo`` part of ``repro.obs``; the metrics registry, spans and
the flight recorder are ROADMAP.md queue 1 item 14.
"""
from . import slo
from .slo import (Slo, SloBreach, SloResult, batcher_slos, breached,
                  default_slos, evaluate_log, evaluate_snapshot,
                  evaluate_values, report, session_slos, train_slos)

__all__ = [
    "slo", "Slo", "SloResult", "SloBreach", "evaluate_values",
    "evaluate_snapshot", "evaluate_log", "breached", "report",
    "default_slos", "session_slos", "batcher_slos", "train_slos",
]

"""The host's ms a racing step in the port's ``scan.prepare`` span: K1's
host preparation (``scan_kernel.prepare_map``), the culling window
selection included. Read from the port's span table over the profiled
stretch of the card's activity alone (``benchmark/spans.py``); None
without it, or when the scan engine is not the kernel."""

from benchmark.spans import race_spans


def read(rec):
    spans = race_spans(rec)
    if spans is None or "scan.prepare" not in spans:
        return None
    return spans["scan.prepare"]["host_ms"] / rec["steps"]

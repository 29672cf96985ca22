"""Seconds of a call's event tables (``EventGeometry``, or
``DeviceEventGeometry``): the median over the window's calls of their
``setup_event_tables`` span."""

import statistics


def read(run):
    values = [c["prof"]["setup_event_tables"] for c in run.calls
              if c["prof"] and "setup_event_tables" in c["prof"]]
    return statistics.median(values) if values else None

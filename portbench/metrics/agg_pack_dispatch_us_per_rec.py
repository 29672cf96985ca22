"""Microseconds per record in the writer thread's packing and dispatch of
the device lane's aggregate windows (the wires, H2D, the launches):
``[fastlane prof]`` ``agg_pack_dispatch`` of the window's calls."""


def read(run):
    return run.prof_us_per_record(("agg_pack_dispatch",))

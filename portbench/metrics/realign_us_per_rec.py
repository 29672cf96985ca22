"""Microseconds per record in the realign lanes (the host C DP or the
device lane's fetch): ``[fastlane prof]`` ``realign_stage`` and
``realign_fetch`` of the window's calls."""


def read(run):
    return run.prof_us_per_record(("realign_stage", "realign_fetch"))

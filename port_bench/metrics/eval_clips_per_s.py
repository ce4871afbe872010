"""Corpus clips fully evaluated per second: the clips of the completed passes
over the time from the window's start to the synchronised end of its last pass."""


def read(reading):
    if not reading.units or reading.window_s <= 0:
        return None
    return reading.units * reading.items_per_unit / reading.window_s

"""Student clips trained per second (labeled and unlabeled): the clips of the
whole steps of the window over its time, the device synchronised at both ends."""


def read(reading):
    if not reading.units or reading.window_s <= 0:
        return None
    return reading.units * reading.items_per_unit / reading.window_s

"""The device's idle share of a QA window, from the union of its device records, %."""
from benchmark.readers import idle_share


def read(r):
    return idle_share(r)

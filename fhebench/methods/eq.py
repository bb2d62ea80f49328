"""``eq``: 1 where two encrypted strings, each padded, are equal."""

from fhebench import reference as ref

PATTERN = "whole"
ENCRYPTED_PATTERN = True
REPLACEMENT = False


def decode(result, text, char):
    return char(result)


def answer(string, pattern, to):
    return int(string == pattern)

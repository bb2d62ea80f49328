"""``find``: the first index of the pattern, sent encrypted, or 255
where there is none (the reference client's convention)."""

from fhebench import reference as ref

PATTERN = "anywhere"
ENCRYPTED_PATTERN = True
REPLACEMENT = False


def decode(result, text, char):
    return char(result)


def answer(string, pattern, to):
    return ref.found_at(string, pattern)

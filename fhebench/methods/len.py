"""``len``: the number of characters before the padding."""

from fhebench import reference as ref

PATTERN = None
ENCRYPTED_PATTERN = False
REPLACEMENT = False


def decode(result, text, char):
    return char(result)


def answer(string, pattern, to):
    return len(string)

"""``contains``: 1 where the string holds the pattern, sent encrypted, else 0."""

from fhebench import reference as ref

PATTERN = "anywhere"
ENCRYPTED_PATTERN = True
REPLACEMENT = False


def decode(result, text, char):
    return char(result)


def answer(string, pattern, to):
    return int(ref.find(string, pattern) >= 0)

"""``starts_with_clear``: 1 where the string begins with the pattern, passed in clear."""

from fhebench import reference as ref

PATTERN = "prefix"
ENCRYPTED_PATTERN = False
REPLACEMENT = False


def decode(result, text, char):
    return char(result)


def answer(string, pattern, to):
    return int(ref.starts_with(string, pattern))

"""``to_lower``: the string with A-Z made lower case."""

from fhebench import reference as ref

PATTERN = None
ENCRYPTED_PATTERN = False
REPLACEMENT = False


def decode(result, text, char):
    return text(result)


def answer(string, pattern, to):
    return ref.map_case(string, ord("A"), ord("Z"), 32)

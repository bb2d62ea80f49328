"""``to_upper``: the string with a-z made upper case."""

from fhebench import reference as ref

PATTERN = None
ENCRYPTED_PATTERN = False
REPLACEMENT = False


def decode(result, text, char):
    return text(result)


def answer(string, pattern, to):
    return ref.map_case(string, ord("a"), ord("z"), -32)

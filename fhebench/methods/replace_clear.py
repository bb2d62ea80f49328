"""``replace_clear``: every match of the clear pattern replaced by the
clear replacement."""

from fhebench import reference as ref

PATTERN = "anywhere"
ENCRYPTED_PATTERN = False
REPLACEMENT = True


def decode(result, text, char):
    return text(result)


def answer(string, pattern, to):
    return ref.replace(string, pattern, to)

"""``split``: the string split at every match of the pattern, sent
encrypted: the program's ``FheSplit``, a grid of one row a possible piece
and the flag that says whether the pattern was found.  A row decrypts to
its piece (up to its first NUL); the pieces are compared after the
reference binary's ``trim_vector``, as its driver compares them."""

import types

from fhebench import split_reference as ref

PATTERN = "anywhere"
ENCRYPTED_PATTERN = True
REPLACEMENT = False


def decode(result, text, char):
    rows = [text(types.SimpleNamespace(blocks=types.SimpleNamespace(ct=ct)))
            for ct in result.buffers.ct]
    return ref.trim_vector(rows), char(result.pattern_found)


def answer(string, pattern, to):
    return (ref.trim_vector(ref.split(string, pattern)),
            ref.pattern_found(string, pattern))

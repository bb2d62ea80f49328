"""``rsplit``: the string split at every match of the pattern, sent
encrypted, searched from the end (Rust's ``rsplit``): the pieces last
first, decoded as ``split``'s."""

from fhebench import split_reference as ref
from fhebench.methods.split import decode  # noqa: F401

PATTERN = "anywhere"
ENCRYPTED_PATTERN = True
REPLACEMENT = False


def answer(string, pattern, to):
    return (ref.trim_vector(ref.rsplit(string, pattern)),
            ref.pattern_found(string, pattern))

"""``split_clear``: ``split`` with the pattern passed in clear."""

from fhebench.methods.split import answer, decode  # noqa: F401

PATTERN = "anywhere"
ENCRYPTED_PATTERN = False
REPLACEMENT = False

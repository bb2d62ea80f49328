"""``rsplit_clear``: ``rsplit`` with the pattern passed in clear."""

from fhebench.methods.rsplit import answer, decode  # noqa: F401

PATTERN = "anywhere"
ENCRYPTED_PATTERN = False
REPLACEMENT = False

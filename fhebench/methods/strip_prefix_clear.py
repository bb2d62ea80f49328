"""``strip_prefix_clear``: the string without the clear pattern where it
begins with it, and the flag that says so.  The stripped string is only
defined with the flag set, so it decodes to None where the flag is 0."""

from fhebench import reference as ref

PATTERN = "prefix"
ENCRYPTED_PATTERN = False
REPLACEMENT = False


def decode(result, text, char):
    rest, flag = text(result.string), char(result.pattern_found)
    return (rest if flag else None), flag


def answer(string, pattern, to):
    if ref.starts_with(string, pattern):
        return string[len(pattern):], 1
    return None, 0

"""Splitting ``{placeholder}`` templates into literal and field parts.

Used by the read-renaming machinery to compile ``--rename`` templates.
Reference parity: tokenizer.py:26-53 of cutadapt:src/cutadapt.
"""

from typing import Iterator


class TokenizeError(Exception):
    pass


class Token:
    __slots__ = ("value",)

    def __init__(self, value: str):
        self.value = value

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other.value == self.value

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.value))

    def __repr__(self) -> str:
        return f'{type(self).__name__}("{self.value}")'


class StringToken(Token):
    """A literal run of template text."""


class BraceToken(Token):
    """The inside of one ``{...}`` placeholder."""


def tokenize_braces(
    s: str, left: str = "{", right: str = "}"
) -> Iterator[Token]:
    """
    Scan a template into StringToken/BraceToken pieces. Unbalanced or
    nested braces raise TokenizeError.

    >>> list(tokenize_braces("before {braced} after"))
    [StringToken("before "), BraceToken("braced"), StringToken(" after")]
    """
    if len(left) != 1 or len(right) != 1 or left == right:
        raise ValueError("left and right must be unequal one-character strings")
    pos = 0
    while pos < len(s):
        open_at = s.find(left, pos)
        close_at = s.find(right, pos)
        if open_at < 0 and close_at < 0:
            yield StringToken(s[pos:])
            return
        if close_at >= 0 and (open_at < 0 or close_at < open_at):
            raise TokenizeError(f"Unexpected '{right}' encountered")
        if open_at > pos:
            yield StringToken(s[pos:open_at])
        close_at = s.find(right, open_at + 1)
        if close_at < 0:
            raise TokenizeError(f"Unexpected '{left}' encountered")
        inner = s[open_at + 1 : close_at]
        if left in inner:
            raise TokenizeError(f"Unexpected '{left}' encountered")
        yield BraceToken(inner)
        pos = close_at + 1

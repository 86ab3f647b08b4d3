"""JSON rendering with per-subtree control over line breaking.

The JSON report keeps most structures fully indented, but histograms
and coordinate pairs read better as single lines. Wrapping any value
in ``OneLine`` makes the renderer emit that whole subtree compactly.

Reference parity: json.py:4-72 of cutadapt:src/cutadapt
(the report's custom dumper; byte-identical output required for JSON
golden comparisons).
"""

import json

_COMPACT = (str, int, float, bool, type(None))


class OneLine:
    """Marks a value whose JSON rendering should not be split."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def dumps(obj, indent: int = 2, _level: int = 0) -> str:
    """
    Render ``obj`` as JSON with ``indent``-space indentation,
    collapsing every ``OneLine``-wrapped subtree onto a single line.

    >>> print(dumps({"a": [1, 2], "b": OneLine([3, 4])}))
    {
      "a": [
        1,
        2
      ],
      "b": [3, 4]
    }
    """
    if isinstance(obj, OneLine):
        return json.dumps(obj.value)
    if isinstance(obj, _COMPACT):
        return json.dumps(obj)

    if isinstance(obj, (list, tuple)):
        items = [dumps(x, indent, _level + 1) for x in obj]
    elif isinstance(obj, dict):
        items = [
            f"{json.dumps(key)}: {dumps(val, indent, _level + 1)}"
            for key, val in obj.items()
        ]
    else:
        raise ValueError(f"cannot serialize type {obj.__class__.__name__}")

    open_ch, close_ch = "[]" if not isinstance(obj, dict) else "{}"
    if not items:
        return open_ch + close_ch
    inner_pad = "\n" + " " * (indent * (_level + 1))
    outer_pad = "\n" + " " * (indent * _level)
    body = ("," + inner_pad).join(items)
    return f"{open_ch}{inner_pad}{body}{outer_pad}{close_ch}"

"""
The adapter-specification mini-language.

One spec string describes an adapter: placement markers (``^A`` /
``A$`` anchor, ``XA`` / ``AX`` forbid internal hits), an ellipsis
(``A...B``) builds linked adapters, ``name=SEQ`` names, ``{n}``
repeats a base, per-adapter parameter overrides follow after ``;``
(``e=``, ``o=``, ``noindels``, ``rightmost``, ``required``,
``optional``, ``anywhere``), and ``file:``/``^file:``/``file$:`` pull
sequences from FASTA.

Parsing is table-driven: `_PARAMETERS` declares the accepted parameter
names/aliases and `_PLACEMENT_CLASSES` maps (type, placement,
rightmost) to the adapter class. Grammar and error wording match the
reference parser (cutadapt:src/cutadapt/parser.py:28-563).
"""

import logging
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Type

from .adapters import (
    Adapter,
    AnywhereAdapter,
    BackAdapter,
    FrontAdapter,
    InvalidCharacter,
    LinkedAdapter,
    NonInternalBackAdapter,
    NonInternalFrontAdapter,
    PrefixAdapter,
    RightmostBackAdapter,
    RightmostFrontAdapter,
    SuffixAdapter,
)
from .io.compressed import xopen
from .io.fastq import parse_fasta

logger = logging.getLogger(__name__)

# accepted ";key=value" parameters: name -> canonical name (None = canonical)
_PARAMETERS: Dict[str, Optional[str]] = {
    "e": "max_error_rate",
    "error_rate": "max_errors",
    "max_error_rate": "max_errors",
    "o": "min_overlap",
    "max_errors": None,
    "min_overlap": None,
    "anywhere": None,
    "required": None,
    "optional": None,
    "indels": None,
    "noindels": None,
    "rightmost": None,
}

# pairs that cannot appear together, and the rewrite applied afterwards:
# (key_a, key_b, replace_b_with, value)
_EXCLUSIVE = (
    ("required", "optional", "required", False),
    ("indels", "noindels", "indels", False),
)

_PLACEMENT_CLASSES: Dict[Tuple[str, Optional[str], bool], Type[Adapter]] = {
    ("front", None, False): FrontAdapter,
    ("front", None, True): RightmostFrontAdapter,
    ("front", "anchored", False): PrefixAdapter,
    ("front", "noninternal", False): NonInternalFrontAdapter,
    ("back", None, False): BackAdapter,
    ("back", None, True): RightmostBackAdapter,
    ("back", "anchored", False): SuffixAdapter,
    ("back", "noninternal", False): NonInternalBackAdapter,
    ("anywhere", None, False): AnywhereAdapter,
}


def parse_search_parameters(spec: str) -> Dict[str, Any]:
    """Parse ``key=value;flag;...`` into a search-parameter dict."""
    result: Dict[str, Any] = {}
    for field in spec.split(";"):
        field = field.strip()
        if not field:
            continue
        key, equals, value = field.partition("=")
        key = key.strip()
        if key not in _PARAMETERS:
            raise KeyError(f"Unknown parameter '{key}'")
        if equals and not value:
            raise ValueError(f"No value given for key '{key}'")
        # resolve aliases to their canonical name
        while _PARAMETERS[key] is not None:
            key = _PARAMETERS[key]
        value = value.strip()
        if not value:
            parsed: Any = True
        else:
            try:
                parsed = int(value)
            except ValueError:
                parsed = float(value)
        if key in result:
            raise KeyError(f"Key '{key}' specified twice")
        result[key] = parsed
    for key_a, key_b, target, target_value in _EXCLUSIVE:
        if key_b not in result:
            continue
        if key_a in result:
            raise ValueError(
                f"'{key_b}' and '{key_a}' cannot be specified at the same time"
                if key_a == "required"
                else f"'{key_a}' and '{key_b}' cannot be specified at the "
                "same time"
            )
        del result[key_b]
        result[target] = target_value
    return result


def expand_braces(sequence: str) -> str:
    """
    Replace every ``x{n}`` with n copies of x ('ACG{3}T' -> 'ACGGGT').
    """
    pieces: List[str] = []
    repeatable = False  # whether a '{n}' may follow here
    i = 0
    n = len(sequence)
    while i < n:
        ch = sequence[i]
        if ch == "{":
            if not repeatable:
                raise ValueError('"{" must be used after a character')
            close = sequence.find("}", i + 1)
            if close < 0:
                raise ValueError("Unterminated expression")
            count = int(sequence[i + 1 : close])  # ValueError on junk
            if not 0 <= count <= 10000:
                raise ValueError(f"Value {count} invalid")
            pieces[-1] = pieces[-1] * count
            repeatable = False
            i = close + 1
        elif ch == "}":
            raise ValueError(
                'Expected "{"' if repeatable else '"}" cannot be used here'
            )
        else:
            pieces.append(ch)
            repeatable = True
            i += 1
    return "".join(pieces)


def _take_placement(spec: str) -> Tuple[Optional[str], Optional[str], str]:
    """Strip placement markers; return (front, back, bare sequence)
    where each side is None, 'anchored' or 'noninternal'."""
    front = back = None
    if spec.startswith("^"):
        front = "anchored"
        spec = spec[1:]
    if spec[:1] in ("x", "X"):
        if front is not None:
            raise ValueError("conflicting front placements")
        front = "noninternal"
        spec = spec.lstrip("xX")
    if spec.endswith("$"):
        back = "anchored"
        spec = spec[:-1]
    if spec[-1:] in ("x", "X"):
        if back is not None:
            raise ValueError("conflicting back placements")
        back = "noninternal"
        spec = spec.rstrip("xX")
    if front is not None and back is not None:
        raise ValueError("front and back placements")
    return front, back, spec


class AdapterSpecification:
    """
    Parsed form of one non-linked adapter spec: its name, placement
    restriction (None, 'anchored' or 'noninternal'), bare sequence,
    parameter overrides, adapter type ('front'/'back'/'anywhere') and
    rightmost preference.
    """

    def __init__(
        self,
        name: Optional[str],
        restriction: Optional[str],
        sequence: str,
        parameters,
        adapter_type: str,
        rightmost: bool,
    ):
        assert restriction in (None, "anchored", "noninternal")
        assert adapter_type in ("front", "back", "anywhere")
        self.name = name
        self.restriction = restriction
        self.sequence = sequence
        self.parameters = parameters
        self.adapter_type = adapter_type
        self.rightmost = rightmost

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(name={self.name!r}, "
            f"restriction={self.restriction!r}, sequence={self.sequence!r}, "
            f"parameters={self.parameters!r}, "
            f"adapter_type={self.adapter_type!r})"
        )

    def __eq__(self, other):
        return (
            self.name == other.name
            and self.restriction == other.restriction
            and self.sequence == other.sequence
            and self.parameters == other.parameters
            and self.adapter_type == other.adapter_type
        )

    @classmethod
    def parse(cls, spec: str, adapter_type: str) -> "AdapterSpecification":
        """Parse a non-linked adapter specification string."""
        if adapter_type not in ("front", "back", "anywhere"):
            raise ValueError("adapter_type must be front, back or anywhere")

        spec, _, parameter_text = spec.partition(";")
        name, _, rest = spec.partition("=")
        if rest:
            name, spec = name.strip(), rest
        else:
            name = None
        spec = spec.strip()
        parameters = parse_search_parameters(parameter_text)
        spec = expand_braces(spec)
        rightmost = parameters.pop("rightmost", False)

        # an all-X "adapter" is legacy colorspace padding: keep as-is
        if not spec.strip("X"):
            return cls(name, None, spec, {}, adapter_type, False)

        try:
            front, back, spec = _take_placement(spec)
        except ValueError:
            raise ValueError(
                "You cannot use multiple placement restrictions for an adapter "
                "at the same time. Choose one of ^ADAPTER, ADAPTER$, XADAPTER "
                "or ADAPTERX"
            ) from None

        if adapter_type == "front" and back is not None:
            raise ValueError(
                "Allowed placement restrictions for a 5' adapter are XADAPTER "
                "and ^ADAPTER"
            )
        if adapter_type == "back" and front is not None:
            raise ValueError(
                "Allowed placement restrictions for a 3' adapter are ADAPTERX "
                "and ADAPTER$"
            )
        restriction = front if front is not None else back

        if adapter_type == "anywhere" and restriction is not None:
            raise ValueError(
                "Placement restrictions (with X, ^, $) not supported for "
                "'anywhere' (-b) adapters"
            )

        if "min_overlap" in parameters and restriction == "anchored":
            raise ValueError(
                "Setting 'min_overlap=' (or 'o=') for anchored adapters is not "
                "possible because anchored adapters always need to match in full."
            )
        if parameters.get("min_overlap", 0) > len(spec):
            parameters["min_overlap"] = len(spec)

        if rightmost and (
            adapter_type not in ("front", "back") or restriction is not None
        ):
            raise ValueError(
                "'rightmost' only allowed with regular 5' and 3' adapters"
            )

        return cls(name, restriction, spec, parameters, adapter_type, rightmost)

    def adapter_class(self) -> Type[Adapter]:
        key = (self.adapter_type, self.restriction, self.rightmost)
        try:
            return _PLACEMENT_CLASSES[key]
        except KeyError:
            if self.adapter_type == "anywhere":
                raise ValueError(
                    'No placement may be specified for "anywhere" adapters'
                ) from None
            raise ValueError(
                f"Value {self.restriction} for a {self.adapter_type} "
                "restriction not allowed"
            ) from None


def make_adapters_from_specifications(
    type_spec_pairs: List[Tuple[str, str]],
    search_parameters: Dict[str, Any],
) -> List[Adapter]:
    """
    Create Adapter instances from (adapter_type, spec string) pairs.
    search_parameters provides defaults that specs can override.
    """
    adapters: List[Adapter] = []
    for adapter_type, spec in type_spec_pairs:
        adapters.extend(
            make_adapters_from_one_specification(
                spec, adapter_type, search_parameters
            )
        )
    return adapters


def make_adapters_from_one_specification(
    spec: str,
    adapter_type: str,
    search_parameters: Dict[str, Any],
) -> Iterable[Adapter]:
    """Parse one adapter spec, yielding one or more Adapter instances
    (several for ``file:`` specs)."""
    if spec.startswith(("file:", "^file:", "file$:")):
        yield from _adapters_from_fasta(spec, adapter_type, search_parameters)
        return
    try:
        yield make_adapter(spec, adapter_type, search_parameters)
    except InvalidCharacter as e:
        if Path(spec).exists():
            raise InvalidCharacter(
                e.args[0] + "\n"
                f"A file exists named '{spec}'. "
                "To use the sequences in that file as adapter sequences, "
                f"write 'file:' before the path, as in 'file:{spec}'."
            )
        raise


def _adapters_from_fasta(
    spec: str, adapter_type: str, search_parameters: Dict[str, Any]
) -> Iterable[Adapter]:
    """Expand a file:/^file:/file$: spec into one adapter per FASTA
    record, transferring the anchoring marker onto each sequence."""
    prefix = suffix = ""
    if spec.startswith("^"):
        prefix, spec = "^", spec[1:]
    elif spec.startswith("file$:"):
        suffix, spec = "$", "file:" + spec[len("file$:") :]
    path, _, parameter_text = spec[len("file:") :].partition(";")
    parameters = {**search_parameters, **parse_search_parameters(parameter_text)}
    for name, sequence in read_adapters_fasta(path):
        yield make_adapter(
            prefix + sequence + suffix, adapter_type, parameters, name=name
        )


def make_adapter(
    spec: str,
    adapter_type: str,
    search_parameters: Dict[str, Any],
    name: Optional[str] = None,
) -> Adapter:
    """
    Parse an adapter specification not using ``file:`` notation.

    adapter_type -- 'back' for -a, 'anywhere' for -b, 'front' for -g.
    """
    if adapter_type not in ("front", "back", "anywhere"):
        raise ValueError("adapter_type must be front, back or anywhere")
    first, ellipsis, second = spec.partition("...")
    if ellipsis and first and second:
        return _make_linked_adapter(
            first, second, name, adapter_type, search_parameters
        )
    if ellipsis:
        spec, adapter_type = _resolve_one_sided_ellipsis(
            first, second, adapter_type
        )
    else:
        spec = first
    return _make_single_adapter(spec, name, adapter_type, search_parameters)


def _resolve_one_sided_ellipsis(
    first: str, second: str, adapter_type: str
) -> Tuple[str, str]:
    """An ellipsis with one empty side marks where the read continues:
    '...A' is a 3' adapter, 'A...' a 5' one."""
    if adapter_type == "anywhere":
        raise ValueError('No ellipsis ("...") allowed in "anywhere" adapters')
    if not first:
        if adapter_type != "back":
            raise ValueError("Invalid adapter specification")
        return second, adapter_type
    if second:
        raise ValueError("Expected either spec1 or spec2")
    if adapter_type == "back":
        return first, "front"
    return first, adapter_type


def _make_linked_adapter(
    spec1: str,
    spec2: str,
    name: Optional[str],
    adapter_type: str,
    search_parameters: Dict[str, Any],
) -> LinkedAdapter:
    """Build a linked adapter from the specs on either side of '...'."""
    if adapter_type == "anywhere":
        raise ValueError("'anywhere' (-b) adapters may not be linked")
    front_spec = AdapterSpecification.parse(spec1, "front")
    back_spec = AdapterSpecification.parse(spec2, "back")
    if name is None:
        name = front_spec.name

    if adapter_type == "front":
        # -g makes both halves mandatory
        defaults = (True, True)
    else:
        # -a requires only the anchored halves
        defaults = (
            front_spec.restriction is not None,
            back_spec.restriction is not None,
        )

    halves = []
    for half_spec, half_name, default_required in zip(
        (front_spec, back_spec), ("linked_front", "linked_back"), defaults
    ):
        parameters = {**search_parameters, **half_spec.parameters}
        required = parameters.pop("required", default_required)
        adapter = half_spec.adapter_class()(
            half_spec.sequence, name=half_name, **parameters
        )
        halves.append((adapter, required))

    (front_adapter, front_required), (back_adapter, back_required) = halves
    return LinkedAdapter(
        front_adapter=front_adapter,
        back_adapter=back_adapter,
        front_required=front_required,
        back_required=back_required,
        name=name,
    )


def _make_single_adapter(
    spec: str,
    name: Optional[str],
    adapter_type: str,
    search_parameters: Dict[str, Any],
) -> Adapter:
    aspec = AdapterSpecification.parse(spec, adapter_type)
    adapter_class = aspec.adapter_class()
    if aspec.parameters.pop("anywhere", False) and adapter_class in (
        FrontAdapter,
        BackAdapter,
        RightmostFrontAdapter,
        RightmostBackAdapter,
    ):
        aspec.parameters["force_anywhere"] = True
    if "required" in aspec.parameters:
        raise ValueError(
            "'required' and 'optional' can only be used within linked adapters"
        )
    parameters = {**search_parameters, **aspec.parameters}
    return adapter_class(
        sequence=aspec.sequence,
        name=aspec.name if name is None else name,
        **parameters,
    )


def read_adapters_fasta(path):
    """Read adapter sequences from a FASTA file."""
    with xopen(path, mode="rb", threads=0) as f:
        for record in parse_fasta(f):
            header = record.name.split(None, 1)
            yield (header[0] if header else None), record.sequence

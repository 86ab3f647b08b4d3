"""Logging: the standard levels plus a REPORT level for one-line reports.

Level layout (why REPORT exists): ``--report=minimal`` must print
exactly one TSV line and nothing else. INFO would drag along the whole
run summary; ERROR would stamp an ``ERROR:`` prefix on it. REPORT sits
between INFO and WARNING so the minimal report passes while everything
chattier is suppressed.

Routing: records below WARNING go to one stream (stderr normally,
stdout when the report itself goes to stderr) with level-name prefixes
for anything unusual; WARNING and above always go to stderr unprefixed.

Reference parity: log.py:6-61 of cutadapt:src/cutadapt.
"""

import logging
import sys

REPORT = 25

_PLAIN_LEVELS = frozenset({logging.INFO, REPORT})


class _LoudHandler(logging.StreamHandler):
    """A StreamHandler whose emit() lets exceptions escape: a report
    that cannot be written must crash the run, not vanish."""

    def emit(self, record):
        text = self.format(record)
        self.stream.write(text)
        self.stream.write(self.terminator)
        self.flush()


class _PrefixingFormatter(logging.Formatter):
    """Stamp 'LEVELNAME: ' on everything except INFO and REPORT."""

    def format(self, record):
        rendered = super().format(record)
        if record.levelno in _PLAIN_LEVELS:
            return rendered
        return f"{record.levelname}: {rendered}"


class _BelowWarning(logging.Filter):
    def filter(self, record):
        return record.levelno < logging.WARNING


def setup_logging(logger, log_to_stderr=True, minimal=False, quiet=False, debug=0):
    """Attach the two handlers described in the module docstring to
    ``logger``. Verbosity: debug beats quiet beats minimal."""
    logging.addLevelName(REPORT, "REPORT")

    if debug > 0:
        level = logging.DEBUG
    elif quiet:
        level = logging.ERROR
    elif minimal:
        level = REPORT
    else:
        level = logging.INFO

    chatter = _LoudHandler(sys.stderr if log_to_stderr else sys.stdout)
    chatter.setFormatter(_PrefixingFormatter())
    chatter.setLevel(level)
    chatter.addFilter(_BelowWarning())

    problems = _LoudHandler(sys.stderr)
    problems.setLevel(logging.WARNING)

    logger.setLevel(level)
    logger.addHandler(chatter)
    logger.addHandler(problems)

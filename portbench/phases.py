"""Per-phase seconds of one job, from its `seqwin.log`.

The program ends each timed phase with a ``- Finished in H:MM:SS.ffffff``
line (`utils.log_elapsed`), and starts it with a heading: an INFO message
that does not begin with `` - `` (warnings and errors inside a phase are no
headings). Each duration is keyed by the heading logged last before it, so
lines that other options add (BLAST's database and search, for instance)
shift nothing.
"""
from __future__ import annotations

import re

# heading prefix -> phase name
HEADINGS = {
    'Building minimizer graph': 'build_graph',
    'Calculating penalty threshold': 'threshold',
    'Extracting low-penalty subgraphs': 'subgraphs',
    'Finding a representative': 'markers',
}
PHASES = tuple(HEADINGS.values())

_FINISHED = re.compile(r'^ - Finished in (?:(\d+) days?, )?(\d+):(\d+):([\d.]+)$')


def _split(line: str) -> tuple[str, str]:
    """(level, message) of a log line (``date | LEVEL | message``)."""
    parts = line.split(' | ', 2)
    return (parts[1].strip(), parts[2]) if len(parts) == 3 else ('INFO', line)


def timed(entries):
    """(phase, heading's stamp, finish line's stamp, seconds) of each phase in
    ``PHASES`` that ``entries`` time; ``entries`` are (level, message, stamp)
    in logging order, and untimed or unknown headings are skipped."""
    heading = None  # (message, stamp)
    for level, msg, stamp in entries:
        m = _FINISHED.match(msg)
        if m:
            days, h, mi, s = m.groups()
            secs = int(days or 0) * 86400 + int(h) * 3600 + int(mi) * 60 + float(s)
            name = heading and next((v for k, v in HEADINGS.items() if heading[0].startswith(k)),
                                    None)
            if name:
                yield name, heading[1], stamp, secs
            heading = None
        elif level == 'INFO' and not msg.startswith(' - '):
            heading = (msg, stamp)


def phase_seconds(log_text: str) -> dict[str, float]:
    """Seconds of each phase in ``PHASES`` the log times (summed if a
    heading repeats)."""
    out: dict[str, float] = {}
    for name, _, _, secs in timed((*_split(line), None) for line in log_text.splitlines()):
        out[name] = out.get(name, 0.0) + secs
    return out

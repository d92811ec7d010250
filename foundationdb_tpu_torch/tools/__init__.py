"""Tools: operator-facing surfaces (ref: fdbcli/, fdbbackup/)."""

import os
import tempfile


def report_path(name: str) -> str:
    """Default path of a tool's report file `name`: in the temp dir
    (TMPDIR), with a prefix of the port's own, so that the reference's
    tools, which write `/tmp/<name>`, never share a file with the
    port's."""
    return os.path.join(tempfile.gettempdir(), "fdbtpu_torch" + name)

"""Tools: operator-facing surfaces (ref: fdbcli/, fdbbackup/)."""

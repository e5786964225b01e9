"""Application shell: session database, MMI command language, circuit
sessions, status view, CLI."""

from . import dbase, mmi, session, view  # noqa: F401

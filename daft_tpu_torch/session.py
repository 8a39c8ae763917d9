"""Session: temp tables, attached catalogs and SQL over them (counterpart of
daft_tpu/session.py). ``sql`` resolves a table from the query's CTEs, then
its bindings, then the session (sql/planner.py); ``daft_tpu_torch.sql``
falls through to ``current_session()``.

A catalog is any object with ``load_table(name)`` (and a ``name``); a
dotted table name ``<catalog>.<rest>`` asks the catalog attached under
``<catalog>``. The reference's ``FilesystemCatalog`` opens Iceberg, Delta
and Hudi tables only, and waits for those readers (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class Session:
    def __init__(self) -> None:
        self._tables: Dict[str, Any] = {}
        self._catalogs: Dict[str, Any] = {}

    # ---- temp tables ---------------------------------------------------------------
    def create_temp_table(self, name: str, df: Any, replace: bool = True) -> None:
        key = name.lower()
        if not replace and key in self._tables:
            raise ValueError(f"table {name!r} already exists")
        self._tables[key] = df

    def drop_temp_table(self, name: str) -> None:
        self._tables.pop(name.lower(), None)

    def get_table(self, name: str) -> Optional[Any]:
        t = self._tables.get(name.lower())
        if t is not None:
            return t
        if "." in name:
            cat_name, rest = name.split(".", 1)
            cat = self._catalogs.get(cat_name.lower())
            if cat is not None:
                return cat.load_table(rest)
        return None

    def list_tables(self) -> List[str]:
        return sorted(self._tables)

    # ---- catalogs ------------------------------------------------------------------
    def attach_catalog(self, catalog: Any, alias: Optional[str] = None) -> None:
        name = alias or getattr(catalog, "name", None) or "default"
        self._catalogs[name.lower()] = catalog

    def detach_catalog(self, alias: str) -> None:
        self._catalogs.pop(alias.lower(), None)

    # ---- sql -----------------------------------------------------------------------
    def sql(self, query: str, **bindings):
        """Plan SQL against this session's tables and catalogs."""
        from .sql import plan

        return plan(query, bindings, self)


_SESSION: Optional[Session] = None


def current_session() -> Session:
    global _SESSION
    if _SESSION is None:
        _SESSION = Session()
    return _SESSION

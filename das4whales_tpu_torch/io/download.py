"""File download with local caching (host side; the port's copy of
``das4whales_tpu.io.download``).

Parity target: reference ``data_handle.dl_file`` (data_handle.py:233-255),
rebuilt on the standard library (urllib) instead of the ``wget`` package,
with atomic writes so an interrupted download never poisons the cache
(download idempotency is the reference's only resume behavior,
SURVEY.md §5.4).
"""

from __future__ import annotations

import os
import shutil
import urllib.request


def dl_file(url: str, datadir: str = "data", quiet: bool = False) -> str:
    """Download ``url`` into ``datadir`` unless already cached; return the
    local path."""
    filename = url.split("/")[-1]
    filepath = os.path.join(datadir, filename)
    if os.path.exists(filepath):
        if not quiet:
            print(f"{filename} already stored locally")
        return filepath
    os.makedirs(datadir, exist_ok=True)
    tmp = filepath + ".part"
    with urllib.request.urlopen(url) as resp, open(tmp, "wb") as out:
        shutil.copyfileobj(resp, out)
    os.replace(tmp, filepath)
    if not quiet:
        print(f"Downloaded {filename}")
    return filepath

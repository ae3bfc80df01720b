"""Checkpoint-URL resolution (port of ``madm_tpu/utils/file_io.py``;
reference: ``utils/file_io.py`` iopath handlers).

The reference registers iopath PathHandlers for ``odise://`` (released MADM/
ODISE checkpoints) and ``sd://`` (Stable Diffusion weights) with a local-zoo
override.  Without egress the catalog resolves exclusively through local
directories: ``MADM_MODEL_ZOO`` (checkpoints) and ``MADM_SD_ZOO`` (SD
snapshots) name them; ``resolve_path`` maps prefixed URLs to files beneath
them.  The port has no default zoo outside the caller's directories: an
unset variable raises.
"""

from __future__ import annotations

import os

PREFIXES = {"odise://": "MADM_MODEL_ZOO", "sd://": "MADM_SD_ZOO"}


def resolve_path(path: str) -> str:
    """Map ``odise://name`` / ``sd://name`` to a local file; passthrough
    otherwise.  Raises FileNotFoundError with the expected location when the
    local zoo does not contain the artifact (zero-egress environment)."""
    for prefix, env in PREFIXES.items():
        if path.startswith(prefix):
            if not os.environ.get(env):
                raise FileNotFoundError(f"{path}: set ${env} to the local directory that holds it")
            root = os.path.expanduser(os.environ[env])
            local = os.path.join(root, path[len(prefix):])
            if not os.path.exists(local):
                raise FileNotFoundError(
                    f"{path}: place the artifact at {local} (no network egress; "
                    f"${env} is the zoo root)"
                )
            return local
    return os.path.expanduser(path)

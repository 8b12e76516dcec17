"""Release/version checking (network-gated).

The port's copy of ``whisperjav_tpu/utils/version_check.py``: the same
messages and the same pip target, ``whisperjav-tpu``, the distribution
both packages ship in. The release poll is the one network call, made by
``fetch`` (default :func:`fetch_release`), which tests replace. It runs
in a worker thread that :func:`check_latest_version` waits on for at
most ``timeout`` seconds, so an offline host (a name lookup that hangs
included) gets None within the timeout.

Role parity with reference ``whisperjav/version_checker.py`` /
``upgrade.py`` (GitHub release polling + self-update). In zero-egress
environments every check returns None gracefully; the ``upgrade``
entry point prints guidance instead of mutating the install — wheel
self-replacement is a package-manager concern in this distribution.

    python -m whisperjav_tpu_torch.utils.version_check [--run | --dry-run]
"""

from __future__ import annotations

import json
import sys
import threading
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional

from whisperjav_tpu_torch.version import __version__

RELEASES_URL = ("https://api.github.com/repos/"
                "whisperjav/whisperjav-tpu/releases/latest")


def parse_version(v: str):
    """'v1.3.0rc1' → (1, 3, 0): leading digits of each dot component.

    Pre-release suffixes contribute their numeric prefix (never dropped —
    dropping made 'v1.3.0rc1' parse as (1, 3) and misorder against 1.2.x).
    """
    import re
    parts = []
    for comp in v.strip().lstrip("v").split(".")[:3]:
        m = re.match(r"(\d+)", comp)
        if m is None:
            break
        parts.append(int(m.group(1)))
    return tuple(parts)


def fetch_release(timeout: float) -> Dict:
    """The latest release's JSON from the GitHub API."""
    with urllib.request.urlopen(RELEASES_URL, timeout=timeout) as r:
        return json.loads(r.read())


def check_latest_version(timeout: float = 5.0,
                         fetch: Optional[Callable[[float], Dict]] = None
                         ) -> Optional[Dict]:
    """Returns {"latest": str, "newer": bool, "url": str} or None when
    offline, when ``fetch`` takes longer than ``timeout``, or when the
    release tag is unparseable."""
    fetch = fetch or fetch_release
    box: Dict = {}

    def poll():
        try:
            box["data"] = fetch(timeout)
        except (urllib.error.URLError, OSError, ValueError, KeyError):
            pass
    worker = threading.Thread(target=poll, daemon=True)
    worker.start()
    worker.join(timeout)
    data = box.get("data")
    if data is None:
        return None
    latest = data.get("tag_name", "")
    if not parse_version(latest):
        return None
    return {
        "latest": latest,
        "newer": parse_version(latest) > parse_version(__version__),
        "url": data.get("html_url"),
    }


def run_pip_upgrade(dry_run: bool = False) -> int:
    """Invoke this interpreter's pip to upgrade the package in place.

    The whole self-updater (reference upgrade.py's wheel download +
    unpack + atomic swap, ~1.5k LoC) collapses to one pip call here
    because the distribution is a plain wheel: pip already does
    resolution, rollback-on-failure, and entry-point regeneration."""
    import subprocess
    cmd = [sys.executable, "-m", "pip", "install", "--upgrade",
           "whisperjav-tpu"]
    if dry_run:
        print("would run:", " ".join(cmd))
        return 0
    return subprocess.call(cmd)


def upgrade_main(argv=None,
                 fetch: Optional[Callable[[float], Dict]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="whisperjav-torch-upgrade",
        description="check for a newer whisperjav-tpu release and "
                    "optionally install it")
    ap.add_argument("--run", action="store_true",
                    help="install the upgrade via pip (default: "
                         "check + print guidance only)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the pip command without executing")
    args = ap.parse_args(argv)

    info = check_latest_version(fetch=fetch)
    if info is None:
        print(f"whisperjav-tpu {__version__} — update check unavailable "
              "(offline)")
        if args.run or args.dry_run:
            # user explicitly asked to upgrade: let pip try/report
            return run_pip_upgrade(dry_run=args.dry_run)
        return 0
    if info["newer"]:
        print(f"newer release available: {info['latest']} "
              f"(current {__version__})")
        if args.run or args.dry_run:
            return run_pip_upgrade(dry_run=args.dry_run)
        print("upgrade with: pip install -U whisperjav-tpu "
              "(or re-run with --run)")
    else:
        print(f"whisperjav-tpu {__version__} is up to date")
    return 0


if __name__ == "__main__":
    sys.exit(upgrade_main())

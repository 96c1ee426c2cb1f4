"""Version metadata of the port (after ``nbasr_tpu/version.py``).

Git introspection is lazy: importing the package spawns no subprocess;
``commit``/``repo``/``has_repo`` are computed on first attribute access
and cached.
"""

import pathlib
import subprocess

__version__ = '0.1.0'
version = __version__

_cache = {}


def _git(*args):
    try:
        out = subprocess.run(
            ['git', *args], cwd=pathlib.Path(__file__).parent,
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        return None


def __getattr__(name):
    if name in ('commit', 'repo', 'has_repo'):
        if 'commit' not in _cache:
            _cache['commit'] = _git('rev-parse', 'HEAD')
            _cache['repo'] = _git('remote', 'get-url', 'origin')
            _cache['has_repo'] = _cache['commit'] is not None
        return _cache[name]
    raise AttributeError(name)

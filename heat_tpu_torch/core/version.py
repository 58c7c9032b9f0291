"""Version information (reference: heat/core/version.py:3-9, heat_tpu/core/version.py)."""

major: int = 0
"""Major version number."""
minor: int = 1
"""Minor version number."""
micro: int = 0
"""Micro version number."""
extension: str = "dev"
"""Version extension marker."""

if not extension:
    __version__ = f"{major}.{minor}.{micro}"
    __pep440__ = __version__
else:
    __version__ = f"{major}.{minor}.{micro}-{extension}"
    # packaging needs a PEP 440 rendering ("-dev" is not one). Only markers
    # with an unambiguous mapping get a release-segment rendering; anything
    # else becomes a local version label rather than silently meaning
    # something different (e.g. "rc1" + "0" would read as rc10).
    import re as _re

    if extension == "dev":
        __pep440__ = f"{major}.{minor}.{micro}.dev0"
    elif _re.fullmatch(r"(?:rc|a|b)\d+", extension):
        __pep440__ = f"{major}.{minor}.{micro}{extension}"
    else:
        __pep440__ = f"{major}.{minor}.{micro}+{extension}"

"""tests/test_paper_claims.py run against the port (see _torch_mirror.py)."""
from _torch_mirror import load

globals().update(load("test_paper_claims"))

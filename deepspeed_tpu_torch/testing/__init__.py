"""Test-support utilities shipped with the port: the chaos harness
(`chaos.py`) and the fabric's tiny seeded engine (`fabric.py`)."""

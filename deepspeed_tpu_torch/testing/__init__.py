"""Test-support utilities shipped with the port: the chaos harness
(`chaos.py`), the fabric's tiny seeded engine (`fabric.py`) and the
checkpoint / recovery fault injection (`faults.py`)."""

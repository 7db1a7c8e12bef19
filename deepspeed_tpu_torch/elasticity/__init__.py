"""Restart budgets shared by the port's supervisors (`restart_policy.py`)."""

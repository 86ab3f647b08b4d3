"""The plain references that decide ``correct`` (see trim.py)."""

"""Evaluation protocols: the port's copy of the ScanNet AP metric."""

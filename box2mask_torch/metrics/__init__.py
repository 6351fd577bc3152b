"""Evaluation protocols: the port's copies of the ScanNet AP, the
ARKitScenes detection AP and its box geometry, and the S3DIS metrics."""

"""Drivers of the traffic kinds. A traffic file names its kind
(`traffic/<name>.json` "kind"), and the harness runs `kinds/<kind>.py`'s
Session: set-up in its constructor, then window, trace, release and
check."""

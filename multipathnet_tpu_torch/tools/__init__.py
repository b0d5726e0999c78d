"""Measurement tools of the port, each named after its counterpart under the
repository's tools/."""

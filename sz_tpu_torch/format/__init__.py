"""Byte-level stream format, byte-equal to the reference SZ2 streams."""

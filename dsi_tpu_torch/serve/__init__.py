"""Serving-side helpers of the port (the host-path word count so far)."""

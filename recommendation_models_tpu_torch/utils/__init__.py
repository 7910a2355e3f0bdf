"""Utilities of the port: checkpoint and resume (``utils.checkpoint``)."""

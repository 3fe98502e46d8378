"""The wire contract: the trace-context header of the messages."""

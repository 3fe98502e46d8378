"""Server state the scheduling tick reads: the core and its workers."""

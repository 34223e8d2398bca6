"""Training substrate: so far checkpointing (``checkpoint``), which the
port's simulation examples use to restart a run (docs/port.md §examples).
The optimizer, data pipeline and loop are not ported yet (ROADMAP Queue
1, item 6)."""

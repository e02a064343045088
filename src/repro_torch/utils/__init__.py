"""Program analysis for the dry run: the dispatched aten program's
FLOPs, bytes and collectives (`hlo`), the roofline terms on an H100
(`roofline`) and the audit of its largest contributors (`audit`); and
the spans and counters of the simulator's loops (`spans`)."""

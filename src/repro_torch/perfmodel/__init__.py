"""HLO-text cost model (the port's copy of the reference's ``perfmodel``
text parsers): `hlo` (dtype sizes, collective bytes) and `hlo_cost`
(`analyze`: trip-count-aware FLOPs and HBM bytes).  Plain ``re``; the
LLM-serving lowering (`repro_torch.traces.llm`) renders decode-step
modules in `hlo_cost.analyze`'s grammar and reads its byte totals.
`roofline` prices a step at the H100's constants and `report` prints
the dry-run's records (`repro_torch.launch.dryrun`)."""

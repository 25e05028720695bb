"""Host bookkeeping of the port: Job, Datum/BaseIteration,
SuccessiveHalving, Result, warm start (WarmStartIteration) and fused-tier
checkpoints."""

"""Host bookkeeping of the port: Job, Datum/BaseIteration, the iteration
types (SuccessiveHalving, SuccessiveResampling, JaxSuccessiveHalving),
Result, warm start (WarmStartIteration), the Master's run loop and the
Master and fused-tier checkpoints."""

"""Host bookkeeping of the port: Job, Datum/BaseIteration,
SuccessiveHalving and Result."""

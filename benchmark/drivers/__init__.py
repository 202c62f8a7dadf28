"""One module a driver, found by the name a cell's file gives (workloads/<cell>.json)."""

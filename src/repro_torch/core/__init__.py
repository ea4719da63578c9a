"""CEMR core, torch port: numpy compile side (graph, filtering, ordering,
encoding, count, plan, ref_engine — copies of `repro.core`) and the torch
runtime (bitops, engine, scheduler)."""

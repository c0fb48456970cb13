"""The launcher's side of the comparison, one module a traffic mode:
numbers(cell, seed, records, device) -> {name: value} from the peers'
records and the plain reference, run once the peers have exited."""

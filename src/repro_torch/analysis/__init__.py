"""repro_torch.analysis — static checks for the invariants the port's
runtime relies on, the counterpart of the reference's ``repro.analysis``.

``python -m repro_torch.analysis src/repro_torch`` lints the tree with
four rule families:

* **NK01** lock discipline — ``@guarded_by`` attributes touched outside
  their lock; lock-acquisition-order violations.
* **NK02** clock discipline — raw ``time.perf_counter``-family calls
  outside the sanctioned timing modules.
* **NK03** host-sync hygiene — impure calls and host syncs inside the
  functions that run on every decode step (the kernel wrappers and the
  runners' step callables); the reference's NK03 looks inside jitted
  and Pallas functions, which the port has none of.
* **NK04** registry hygiene — duplicate registrations and unparseable
  spec strings.

Pure AST: never imports the code under analysis.  NK01, NK02 and NK04
are the reference's rules, their logic unchanged.
"""
from repro_torch.analysis.core import (Finding, Module, Project, Rule,
                                       all_rules, run_rules)

__all__ = ["Finding", "Module", "Project", "Rule", "all_rules", "run_rules"]

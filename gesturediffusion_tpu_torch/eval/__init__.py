"""Evaluation protocols of the port: the action-to-motion benchmark
(HumanAct12, UESTC), the unconstrained MoDi metrics and their metric math,
the text-to-motion benchmark and its CompV6 baseline, and the trainers that
regenerate the evaluators."""

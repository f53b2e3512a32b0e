"""Evaluation protocols of the port: the action-to-motion benchmark
(HumanAct12, UESTC), the unconstrained MoDi metrics and their metric math."""

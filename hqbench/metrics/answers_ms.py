"""answers_ms: the workers' answers through the port's handlers
(`on_task_running`, `on_task_finished`, `on_task_failed`,
`on_retract_response`), their time since the tick before as the program
sums it, mean a tick (a tick with no answers counts 0)."""

from hqbench.metrics._since import answers_on, since
from hqbench.metrics._util import mean


def read(view):
    if not answers_on(view):
        return None
    return mean(s.get("answers", 0.0) for s in since(view))

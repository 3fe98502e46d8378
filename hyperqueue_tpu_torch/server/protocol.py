"""Wire codecs for resource requests and task descriptions.

Reference: crates/hyperqueue/src/transfer/messages.rs (client<->server DTOs)
and crates/tako/src/internal/messages/worker.rs (server<->worker). Resource
requests travel as name-keyed dicts (workers and clients don't know the
server's interned ids); the server converts to interned form on arrival.
"""

from __future__ import annotations

from hyperqueue_tpu_torch.resources.map import ResourceIdMap
from hyperqueue_tpu_torch.resources.request import (
    AllocationPolicy,
    ResourceRequest,
    ResourceRequestEntry,
    ResourceRequestVariants,
)


def submit_record(job_desc: dict, n_tasks: int) -> dict:
    """Summary of one submit echoed in job detail (reference
    JobDetail.submit_descs): the wire resource request plus task count.
    A graph submit with heterogeneous per-task requests echoes the deduped
    list under "requests" instead of misreporting tasks[0]'s as THE
    request."""
    array = job_desc.get("array")
    if array:
        return {"n_tasks": n_tasks, "request": array.get("request") or {}}
    distinct: list[dict] = []
    for t in job_desc.get("tasks") or []:
        request = t.get("request") or {}
        if request not in distinct:
            distinct.append(request)
    if len(distinct) <= 1:
        return {"n_tasks": n_tasks,
                "request": distinct[0] if distinct else {}}
    return {"n_tasks": n_tasks, "requests": distinct}


def array_desc_ids(array: dict) -> list[int]:
    """The task ids of a wire array description: explicit "ids" list or
    the chunked-submit "id_range" [start, stop) compact form."""
    id_range = array.get("id_range")
    if id_range is not None:
        return list(range(int(id_range[0]), int(id_range[1])))
    return list(array["ids"])


def expand_desc_tasks(job_desc: dict) -> list[dict]:
    """Expand a submit description into per-task dicts (array or graph form).

    Used where per-task iteration is needed anyway (journal restore, detail
    queries); the live submit path keeps the compressed array form.
    """
    array = job_desc.get("array")
    if not array:
        return list(job_desc.get("tasks", []))
    out = []
    entries = array.get("entries")
    shared_body = array.get("body", {})
    for i, task_id in enumerate(array_desc_ids(array)):
        task = {
            "id": task_id,
            # ONE body object for the whole array; the entry travels as its
            # own field so the compute-message body dedup survives restore
            "body": shared_body,
            "request": array.get("request") or {},
            "priority": array.get("priority", 0),
            "crash_limit": array.get("crash_limit", 5),
        }
        if entries is not None:
            task["entry"] = entries[i]
        out.append(task)
    return out


def rqv_to_wire(rqv: ResourceRequestVariants, resource_map: ResourceIdMap) -> dict:
    return {
        "variants": [
            {
                "n_nodes": v.n_nodes,
                "min_time": v.min_time_secs,
                "weight": v.weight,
                "entries": [
                    {
                        "name": resource_map.name_of(e.resource_id),
                        "amount": e.amount,
                        "policy": e.policy.value,
                    }
                    for e in v.entries
                ],
            }
            for v in rqv.variants
        ]
    }


def rqv_from_wire(data: dict, resource_map: ResourceIdMap) -> ResourceRequestVariants:
    variants = []
    for v in data.get("variants") or [{}]:
        entries_list = []
        for e in v.get("entries", []):
            entries_list.append(
                ResourceRequestEntry(
                    resource_id=resource_map.get_or_create(e["name"]),
                    amount=int(e["amount"]),
                    policy=AllocationPolicy.parse(e.get("policy", "compact")),
                )
            )
            if e.get("group") is not None:
                # non-fungible indexed constraint ("group k of gpus"):
                # one extra dense mask entry against the per-group
                # subcolumn, NOT a materialized per-group variant — the
                # batched solve sees it as one more needs row
                entries_list.append(
                    ResourceRequestEntry(
                        resource_id=resource_map.get_or_create_masked(
                            e["name"], int(e["group"])
                        ),
                        amount=int(e["amount"]),
                    )
                )
        entries = tuple(entries_list)
        if not entries and not v.get("n_nodes"):
            # default: 1 cpu
            entries = (
                ResourceRequestEntry(
                    resource_id=resource_map.get_or_create("cpus"),
                    amount=10_000,
                ),
            )
        variants.append(
            ResourceRequest(
                entries=entries,
                n_nodes=int(v.get("n_nodes", 0)),
                min_time_secs=float(v.get("min_time", 0.0)),
                weight=float(v.get("weight", 1.0)),
            )
        )
    rqv = ResourceRequestVariants(variants=tuple(variants))
    rqv.validate()
    return rqv

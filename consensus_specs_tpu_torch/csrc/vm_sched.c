/* Bucketed list scheduling + liveness + LIFO linear-scan register
 * allocation for the field-ALU VM assembler (ops/vm.py). The port's copy
 * of csrc/vm_sched.c, unchanged but for this comment.
 *
 * Semantics are IDENTICAL to the pure-Python path in Prog.assemble(),
 * which is itself gated bit-identical to the legacy reference scheduler
 * (tests/test_vm_scheduler.py): every ALU op lands on the first step >=
 * max(operand steps) + 1 whose unit has a free lane, lanes fill in op
 * creation order, registers are claimed most-recently-freed-first and
 * freed after each step's last use. The native kernel exists purely for
 * throughput — the ~1M ops/sec Python loops become ~30M+ ops/sec here,
 * so a .vm_cache-miss assembly of the chunk-16 rlc_combine is dominated
 * by IR extraction instead of scheduling.
 *
 * Build: ops/vm.py compiles it with the host C compiler at first use into
 * consensus_specs_tpu_torch/_build/ (the library's name carries the
 * source digest) and loads it through ctypes; without a compiler the
 * pure-Python scheduler runs instead.
 *
 * kind[n]: -2 const, -1 input, 0 mul, 1 add, 2 sub
 * a[n], b[n]: operand op indices (const payloads sanitized to 0)
 * outs[n_out]: output op indices (live to n_steps + 1)
 * step/last_use/reg[n]: outputs
 * meta_out[2]: n_steps, alloc_regs (next_reg)
 * returns 0 on success, -1 on allocation failure
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

int vm_schedule_alloc(int64_t n, const int64_t *kind, const int64_t *a,
                      const int64_t *b, int64_t w_mul, int64_t w_lin,
                      int64_t n_out, const int64_t *outs, int64_t *step,
                      int64_t *last_use, int64_t *reg, int64_t *meta_out)
{
    int64_t cap = n + 2;
    int64_t *fill[2], *nxt[2], ln[2] = {0, 0}, width[2];
    int64_t i, t, u, r, x, lnu, n_steps, next_reg, n_alu = 0;
    int rc = -1;

    width[0] = w_mul;
    width[1] = w_lin;
    fill[0] = malloc(cap * sizeof(int64_t));
    fill[1] = malloc(cap * sizeof(int64_t));
    nxt[0] = malloc(cap * sizeof(int64_t));
    nxt[1] = malloc(cap * sizeof(int64_t));
    if (!fill[0] || !fill[1] || !nxt[0] || !nxt[1])
        goto done_sched;

    /* 1) placement: per-unit lane-fill counters + union-find over steps
     * ("first step >= t with a free lane"; full steps point past
     * themselves, finds path-compress) */
    for (i = 0; i < n; i++) {
        int64_t k = kind[i];
        int64_t *f, *nx;
        if (k < 0) {
            step[i] = -1;
            continue;
        }
        n_alu++;
        {
            int64_t sa = step[a[i]], sb = step[b[i]];
            t = (sa >= sb ? sa : sb) + 1;
        }
        u = (k == 0) ? 0 : 1;
        f = fill[u];
        nx = nxt[u];
        lnu = ln[u];
        if (t >= lnu) {
            while (lnu <= t) {
                nx[lnu] = lnu;
                f[lnu] = 0;
                lnu++;
            }
            r = t;
        } else {
            r = t;
            x = nx[r];
            if (x != r) {
                /* walk to the root, then path-compress the chain */
                int64_t start = r;
                for (;;) {
                    r = x;
                    if (r == lnu) {
                        nx[lnu] = lnu;
                        f[lnu] = 0;
                        lnu++;
                        break;
                    }
                    x = nx[r];
                    if (x == r)
                        break;
                }
                x = start;
                while (nx[x] != r) {
                    int64_t nxx = nx[x];
                    nx[x] = r;
                    x = nxx;
                }
            }
        }
        ln[u] = lnu;
        if (++f[r] == width[u])
            nx[r] = r + 1;
        step[i] = r;
    }
    n_steps = ln[0] >= ln[1] ? ln[0] : ln[1];
    rc = 0;
done_sched:
    free(fill[0]);
    free(fill[1]);
    free(nxt[0]);
    free(nxt[1]);
    if (rc != 0)
        return rc;

    /* 2) liveness: last step at which each value is read */
    for (i = 0; i < n; i++)
        last_use[i] = -1;
    for (i = 0; i < n; i++) {
        if (kind[i] < 0)
            continue;
        t = step[i];
        if (last_use[a[i]] < t)
            last_use[a[i]] = t;
        if (last_use[b[i]] < t)
            last_use[b[i]] = t;
    }
    for (i = 0; i < n_out; i++)
        last_use[outs[i]] = n_steps + 1; /* live to the end */

    /* 3) allocation: creation-order ALU ops bucketed by step (counting
     * sort — stable, matching the by-step walk), LIFO free stack,
     * per-step expiry buckets sized by a last-use histogram */
    {
        int64_t nb = n_steps + 2;
        int64_t *bucket_off = calloc(nb + 1, sizeof(int64_t));
        int64_t *bucket = malloc((n_alu > 0 ? n_alu : 1) * sizeof(int64_t));
        int64_t *exp_off = calloc(nb + 1, sizeof(int64_t));
        int64_t *exp_fill, *expiry = NULL, *stack = NULL;
        int64_t sp = 0, e;

        rc = -1;
        exp_fill = calloc(nb, sizeof(int64_t));
        stack = malloc((n > 0 ? n : 1) * sizeof(int64_t));
        if (!bucket_off || !bucket || !exp_off || !exp_fill || !stack)
            goto done_alloc;

        for (i = 0; i < n; i++) {
            if (kind[i] >= 0)
                bucket_off[step[i] + 1]++;
            /* expiry histogram: every allocated value that is freed
             * lands in exactly one step bucket */
            e = last_use[i];
            if (kind[i] < 0) {
                if (e < 0)
                    continue; /* dead input/const: never freed */
            } else if (e < 0) {
                e = step[i]; /* dead value: freed right after its step */
            }
            if (e < nb)
                exp_off[e + 1]++;
        }
        for (i = 0; i < nb; i++) {
            bucket_off[i + 1] += bucket_off[i];
            exp_off[i + 1] += exp_off[i];
        }
        expiry = malloc((exp_off[nb] > 0 ? exp_off[nb] : 1)
                        * sizeof(int64_t));
        if (!expiry)
            goto done_alloc;
        {
            int64_t *bfill = calloc(nb, sizeof(int64_t));
            if (!bfill)
                goto done_alloc;
            for (i = 0; i < n; i++)
                if (kind[i] >= 0) {
                    t = step[i];
                    bucket[bucket_off[t] + bfill[t]++] = i;
                }
            free(bfill);
        }

        next_reg = 1;
        /* inputs and constants first, creation order */
        for (i = 0; i < n; i++) {
            if (kind[i] >= 0)
                continue;
            r = sp ? stack[--sp] : next_reg++;
            reg[i] = r;
            e = last_use[i];
            if (e >= 0 && e < nb)
                expiry[exp_off[e] + exp_fill[e]++] = r;
        }
        /* then step by step: allocate defs, free after last use */
        for (t = 0; t < n_steps; t++) {
            int64_t j;
            for (j = bucket_off[t]; j < bucket_off[t + 1]; j++) {
                int64_t op = bucket[j];
                r = sp ? stack[--sp] : next_reg++;
                reg[op] = r;
                e = last_use[op];
                if (e < 0)
                    e = t;
                if (e < nb)
                    expiry[exp_off[e] + exp_fill[e]++] = r;
            }
            for (j = exp_off[t]; j < exp_off[t] + exp_fill[t]; j++)
                stack[sp++] = expiry[j];
        }
        rc = 0;
done_alloc:
        free(bucket_off);
        free(bucket);
        free(exp_off);
        free(exp_fill);
        free(expiry);
        free(stack);
        if (rc != 0)
            return rc;
    }

    meta_out[0] = n_steps;
    meta_out[1] = next_reg;
    return 0;
}
